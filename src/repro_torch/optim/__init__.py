from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
