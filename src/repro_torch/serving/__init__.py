from repro_torch.serving.engine import (FunctionInstance, ServeRequest,
                                        ServingEngine)
from repro_torch.serving.frontend import ClusterFrontend, InstancePlacement
from repro_torch.serving.modelstore import (ColdStartEvent, FleetModelStore,
                                            HostWeightCache, StagedWeights,
                                            stage_params, upload_params)
from repro_torch.serving.paging import (NULL_BLOCK, BlockExhausted,
                                        KVPageAllocator, PageTable,
                                        blocks_needed)

__all__ = ["ServingEngine", "FunctionInstance", "ServeRequest",
           "ClusterFrontend", "InstancePlacement",
           "FleetModelStore", "ColdStartEvent", "HostWeightCache",
           "StagedWeights", "stage_params", "upload_params",
           "KVPageAllocator", "PageTable", "BlockExhausted", "NULL_BLOCK",
           "blocks_needed"]
