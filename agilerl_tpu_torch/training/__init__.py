"""Training loops of the port, the multi-process pod launcher
(``launch.py``) and elastic PBT (``train_elastic.py``)."""

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
from agilerl_tpu_torch.training.train_elastic import train_elastic_pbt

__all__ = [
    "PodLauncher", "launch_flywheel", "flywheel_launcher", "read_loss_stream",
    "rollout_role", "learner_role", "driver_role", "idle_role", "train_elastic_pbt",
]
