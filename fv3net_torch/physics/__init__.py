"""Column physics on tensors, batched over all columns (port of
``fv3net_tpu/physics``).  All schemes take (..., nz) z-last columns;
level 0 = top."""
from fv3net_torch.physics.driver import PhysicsConfig, physics_step  # noqa: F401
