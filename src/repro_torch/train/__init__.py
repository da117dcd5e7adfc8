from repro_torch.train.checkpoint import save_checkpoint, restore_checkpoint  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainConfig  # noqa: F401
