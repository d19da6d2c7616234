from .model_config import ModelConfig, MODEL_PRESETS, get_model_config  # noqa: F401
from .engine_config import EngineConfig, CacheConfig, SchedulerConfig, ParallelConfig, ResilienceConfig, QoSTier  # noqa: F401
