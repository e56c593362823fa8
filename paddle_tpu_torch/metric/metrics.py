"""Alias module: ``paddle.metric.metrics`` — scripts that import the long
path keep working (the classes live in the package)."""


def __getattr__(name):
    from paddle_tpu_torch import metric as _m

    try:
        return getattr(_m, name)
    except AttributeError:
        raise AttributeError(
            f"module 'paddle_tpu_torch.metric.metrics' has no attribute "
            f"{name!r}")
