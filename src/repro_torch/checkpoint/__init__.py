from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
