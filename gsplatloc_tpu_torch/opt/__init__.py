from .adam import AdamState, adam_init, adam_step  # noqa: F401
from .tracking import PairResult, TrackingConfig, optimize_pose  # noqa: F401
