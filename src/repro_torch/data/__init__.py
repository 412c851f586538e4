from repro_torch.data.pipeline import (RequestStream, ShareGPTStats,
                                       TrainPipeline, sharegpt_stream,
                                       train_batches)

__all__ = ["RequestStream", "ShareGPTStats", "TrainPipeline",
           "sharegpt_stream", "train_batches"]
