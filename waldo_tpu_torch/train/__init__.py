from .checkpoint import CheckpointManager, normalize_which
from .evaluator import Evaluator, save_video_frames
from .train_state import NetState
from .trainer import Trainer
