from .checkpoint import CheckpointManager, normalize_which
from .train_state import NetState
from .trainer import Trainer
