"""Data parallelism over processes, one item a rank (``torch.distributed``)."""

from .data_parallel import (broadcast_params, init_from_env, init_group,
                            make_dp_train_scan, make_dp_train_step,
                            reduce_gradients, world)

__all__ = ["broadcast_params", "init_from_env", "init_group",
           "make_dp_train_scan", "make_dp_train_step", "reduce_gradients",
           "world"]
