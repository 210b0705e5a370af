"""Training loops of the port, and the multi-process pod launcher
(``launch.py``)."""

from agilerl_tpu_torch.training.launch import (
    PodLauncher,
    driver_role,
    flywheel_launcher,
    idle_role,
    launch_flywheel,
    learner_role,
    read_loss_stream,
    rollout_role,
)

__all__ = [
    "PodLauncher", "launch_flywheel", "flywheel_launcher", "read_loss_stream",
    "rollout_role", "learner_role", "driver_role", "idle_role",
]
