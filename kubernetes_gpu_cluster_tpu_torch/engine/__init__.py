from .kv_cache import KVCache, PageAllocator  # noqa: F401
from .sampling_params import SamplingParams  # noqa: F401
from .sequence import Sequence, SequenceStatus, FinishReason  # noqa: F401
from .scheduler import Scheduler, ScheduledBatch  # noqa: F401
from .engine import LLMEngine, RequestOutput  # noqa: F401
