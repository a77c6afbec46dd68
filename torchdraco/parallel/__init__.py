from .batch import (
    BatchEncoder, PreparedTopology, device_encode_group, encode_with_topology,
    gathers_to_torch, quantize_positions_host, topology_gathers_np,
    topology_signature,
)
from .decode_batch import BatchDecoder
from .multihost import encode_corpus_multihost, init_distributed, shard_corpus
from .transcode import transcode_corpus

__all__ = ["BatchDecoder", "BatchEncoder", "PreparedTopology",
           "device_encode_group", "encode_corpus_multihost",
           "encode_with_topology", "gathers_to_torch", "init_distributed",
           "quantize_positions_host", "shard_corpus", "topology_gathers_np",
           "topology_signature", "transcode_corpus"]
