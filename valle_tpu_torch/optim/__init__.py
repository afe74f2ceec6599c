from .eve import Eve  # noqa: F401
from .scaled_adam import ScaledAdam  # noqa: F401
from .schedules import cosine_lr, eden_lr, get_lr_fn, noam_lr  # noqa: F401
