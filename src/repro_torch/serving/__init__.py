from repro_torch.core.cache import CacheLayout  # noqa: F401
from repro_torch.serving.chaos import (FAULT_POINTS, ChaosError,  # noqa: F401
                                       ChaosInjector)
from repro_torch.serving.config import CacheSpec, EngineConfig, MeshSpec  # noqa: F401
from repro_torch.serving.engine import (Engine, FinishReason,  # noqa: F401
                                        ModelRunner, Request, RequestResult,
                                        Scheduler, ServeStats,
                                        bytes_tokenizer_decode,
                                        bytes_tokenizer_encode)
from repro_torch.serving.paging import (PagePool, PrefixMatch,  # noqa: F401
                                        RadixCache, check_invariants)
