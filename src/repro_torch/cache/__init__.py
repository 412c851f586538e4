from repro_torch.cache.block_manager import (BlockManager, OutOfBlocks,
                                             PageResidency, PrefixMatch)
from repro_torch.cache.quant import (FP8_DTYPE, FP8_MAX, dequantize_fp8,
                                     dequantize_latent, quantize_fp8,
                                     quantize_latent)

__all__ = ["BlockManager", "FP8_DTYPE", "FP8_MAX", "OutOfBlocks",
           "PageResidency", "PrefixMatch", "dequantize_fp8", "dequantize_latent",
           "quantize_fp8", "quantize_latent"]
