from repro_torch.data.pipeline import (Prefetcher, Source, SyntheticText,
                                       lm_batches, register_tokenizer_image)

__all__ = ["Prefetcher", "Source", "SyntheticText", "lm_batches",
           "register_tokenizer_image"]
