"""Learning-rate schedules: Step / Warmup / Constant, a port of
``animatablegaussians_tpu/training/lr_schedule.py`` (ref:
utils/lr_schedule.py:14-65) as plain functions of the update count k.

optax evaluates a schedule at the count of updates done so far, so update
k (from 0) takes ``sched(k)``: a ``LambdaLR(optimizer, sched)`` on an
optimizer built with ``lr=1.0`` does the same.
"""

from __future__ import annotations


def constant_schedule(value: float):
    return lambda step: float(value)


def step_schedule(initial: float, interval: int, factor: float,
                  min: float | None = None):
    def sched(step):
        lr = initial * factor ** float(step // interval)
        return lr if min is None else max(lr, min)
    return sched


def warmup_schedule(initial: float, warmed_up: float, length: int):
    def sched(step):
        return initial + (warmed_up - initial) * min(step / length, 1.0)
    return sched


def get_learning_rate_schedule(type: str, **kw):
    """The YAML factory with the reference's schema (ref:
    utils/lr_schedule.py:41-65; ``train.lr.network`` of the template
    configs)."""
    if type == "Step":
        return step_schedule(kw["initial"], kw["interval"], kw["factor"],
                             kw.get("min"))
    if type == "Warmup":
        return warmup_schedule(kw["initial"], kw["final"], kw["length"])
    if type == "Constant":
        return constant_schedule(kw["value"])
    raise ValueError(f"Unknown lr schedule type {type}")

