"""Synthetic data and the host-sharded LM data pipeline (numpy, bit-equal
to ``repro.data``)."""
from repro_torch.data.pipeline import HostShardedLoader, ProducerError, lm_batch_fn
from repro_torch.data.synthetic import zipf_token_stream

__all__ = ["HostShardedLoader", "ProducerError", "lm_batch_fn", "zipf_token_stream"]
