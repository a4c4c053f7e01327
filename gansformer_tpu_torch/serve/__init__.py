from gansformer_tpu_torch.serve.programs import (DEFAULT_BUCKETS,
                                                 GeneratorBundle,
                                                 ServePrograms, bucket_for,
                                                 init_generator, noise_seed,
                                                 seeds_to_z, sorted_buckets)

__all__ = ["DEFAULT_BUCKETS", "GeneratorBundle", "ServePrograms",
           "bucket_for", "init_generator", "noise_seed", "seeds_to_z",
           "sorted_buckets"]
