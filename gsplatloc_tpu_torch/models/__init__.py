from .gaussians import GaussianScene  # noqa: F401
from .pose import PoseState  # noqa: F401
