"""Models: Gaussian parameters, DualStyleUNet, AvatarNet."""
