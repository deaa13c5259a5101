from .engine import Request, ServeConfig, StaticBatchEngine  # noqa: F401
