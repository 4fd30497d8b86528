from repro_torch.optim.adam import AdamW, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
