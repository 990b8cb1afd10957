"""Synthetic datasets, partitions, client batching and the population
stores (counterpart of ``repro/data``)."""
from repro_torch.data.synthetic import (
    make_char_corpus,
    make_image_classification,
    make_word_corpus,
)
from repro_torch.data.partition import (
    FederatedDataset,
    partition_dirichlet,
    partition_iid,
    partition_pathological_noniid,
    partition_unbalanced,
)
from repro_torch.data.batching import (
    batch_iterator,
    client_epoch_batches,
    estimate_pool_nbytes,
    pad_cohort,
    pool_metadata,
    windows_from_sequence,
)
from repro_torch.data.pool import (
    ClientPool,
    DeviceClientPool,
    StreamedClientPool,
    device_pool_budget,
)
