from repro_torch.training.checkpoint import restore, save  # noqa: F401
from repro_torch.training.data import DataConfig, PackedDataset  # noqa: F401
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm, lr_at,
)
from repro_torch.training.train_loop import (  # noqa: F401
    TrainResult, lm_loss, make_train_step, train,
)
