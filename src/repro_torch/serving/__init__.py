from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import (PH_DECODING, PH_FINISHED, PH_FREE,
                                          PH_PREFILL, SlotManager,
                                          extract_slot_caches,
                                          insert_slot_caches)
from repro_torch.serving.streams import (OP_STREAM_HIGH, OP_STREAM_LOW,
                                         StreamFrontend, StreamRequest)

__all__ = ["OP_STREAM_HIGH", "OP_STREAM_LOW", "PH_DECODING", "PH_FINISHED",
           "PH_FREE", "PH_PREFILL", "ServingEngine", "SlotManager",
           "StreamFrontend", "StreamRequest", "extract_slot_caches",
           "insert_slot_caches"]
