from repro_torch.serving.engine import (FunctionInstance, ServeRequest,
                                        ServingEngine)
from repro_torch.serving.paging import (NULL_BLOCK, BlockExhausted,
                                        KVPageAllocator, PageTable,
                                        blocks_needed)

__all__ = ["ServingEngine", "FunctionInstance", "ServeRequest",
           "KVPageAllocator", "PageTable", "BlockExhausted", "NULL_BLOCK",
           "blocks_needed"]
