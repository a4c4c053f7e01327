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
from gansformer_tpu_torch.serve.warmstart import default_manifest_dir

__all__ = ["DEFAULT_BUCKETS", "FIDELITY_TOLERANCES", "GeneratorBundle",
           "SERVE_PRECISIONS", "ServePrograms", "WARM_KINDS", "WCache",
           "bucket_for", "cost_report", "default_manifest_dir",
           "fidelity_report", "init_generator", "load_generator",
           "map_rows", "noise_seed", "param_tree_bytes", "quantize_params",
           "seeds_to_z", "sorted_buckets", "wcache_key"]
