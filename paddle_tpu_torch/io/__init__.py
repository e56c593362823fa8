"""paddle_tpu_torch.io — datasets, samplers and the DataLoader (port of
``paddle_tpu.io``), and the native ``InMemoryDataset`` /
``MultiSlotInMemoryDataset``."""
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         default_convert_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .in_memory_dataset import InMemoryDataset, MultiSlotInMemoryDataset
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "DataLoader", "WorkerInfo",
           "default_collate_fn", "default_convert_fn", "get_worker_info",
           "InMemoryDataset", "MultiSlotInMemoryDataset"]
