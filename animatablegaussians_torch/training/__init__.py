"""Training: losses, the LPIPS perceptual loss, and the avatar train steps."""
