from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import (PH_DECODING, PH_FINISHED, PH_FREE,
                                          PH_PREFILL, SlotManager,
                                          extract_slot_caches,
                                          insert_slot_caches)

__all__ = ["PH_DECODING", "PH_FINISHED", "PH_FREE", "PH_PREFILL",
           "ServingEngine", "SlotManager", "extract_slot_caches",
           "insert_slot_caches"]
