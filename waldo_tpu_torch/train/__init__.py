from .checkpoint import CheckpointManager, normalize_which
from .evaluator import Evaluator, save_video_frames
from .logger import Logger
from .train_state import NetState
from .trainer import Trainer
