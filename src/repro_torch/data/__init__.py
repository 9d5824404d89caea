from repro_torch.data.pipeline import DataConfig, prefetched, synthetic_batches

__all__ = ["DataConfig", "prefetched", "synthetic_batches"]
