"""Typed configs, metrics (ATE/RPE), timers."""

from pslam.utils.config import SlamConfig, Capacities  # noqa: F401
from pslam.utils.metrics import ate_rmse, align_se3  # noqa: F401


def require(module: str, package: str):
    """Import an optional dependency that only a side path uses (PNG
    decoding, plots), or raise an ImportError naming the package to
    install."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{module} is needed here: install the {package!r} package"
        ) from e
