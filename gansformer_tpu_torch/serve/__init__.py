from gansformer_tpu_torch.serve.cache import WCache, map_rows, wcache_key
from gansformer_tpu_torch.serve.programs import (DEFAULT_BUCKETS,
                                                 SERVE_PRECISIONS,
                                                 WARM_KINDS,
                                                 GeneratorBundle,
                                                 ServePrograms, bucket_for,
                                                 init_generator,
                                                 load_generator, noise_seed,
                                                 seeds_to_z, sorted_buckets)
from gansformer_tpu_torch.serve.quant import (FIDELITY_TOLERANCES,
                                              cost_report, fidelity_report,
                                              param_tree_bytes,
                                              quantize_params)
from gansformer_tpu_torch.serve.replicas import Replica, ReplicaSet
from gansformer_tpu_torch.serve.service import (HEALTH_CLOSED,
                                                HEALTH_DEGRADED,
                                                HEALTH_NAMES, HEALTH_READY,
                                                HEALTH_UNHEALTHY, Cancelled,
                                                Expired, GenerationService,
                                                Overloaded, ServeError,
                                                ServiceClosed,
                                                ServiceUnhealthy, Ticket)
from gansformer_tpu_torch.serve.warmstart import default_manifest_dir

__all__ = ["Cancelled", "DEFAULT_BUCKETS", "Expired", "FIDELITY_TOLERANCES",
           "GenerationService", "GeneratorBundle", "HEALTH_CLOSED",
           "HEALTH_DEGRADED", "HEALTH_NAMES", "HEALTH_READY",
           "HEALTH_UNHEALTHY", "Overloaded", "Replica", "ReplicaSet",
           "SERVE_PRECISIONS", "ServeError", "ServePrograms",
           "ServiceClosed", "ServiceUnhealthy", "Ticket", "WARM_KINDS",
           "WCache", "bucket_for", "cost_report", "default_manifest_dir",
           "fidelity_report", "init_generator", "load_generator",
           "map_rows", "noise_seed", "param_tree_bytes", "quantize_params",
           "seeds_to_z", "sorted_buckets", "wcache_key"]
