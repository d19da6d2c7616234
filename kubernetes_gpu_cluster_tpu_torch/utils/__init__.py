from .math import cdiv, round_up  # noqa: F401
from .logging import get_logger  # noqa: F401
