"""De novo genome assembler on accelerators (JAX / XLA).

A framework with the capabilities of the reference single-CPU De Bruijn
assembler (see SURVEY.md), redesigned around fixed-shape device arrays:

  * ``utils``    — 2-bit data model, config, seeded read simulator, metrics.
  * ``ops``      — k-mer extraction + sort/segment-reduce counting, graph
                   construction, on-device unitig compression.
  * ``parallel`` — ``shard_map`` multi-device pipeline: data-parallel reads,
                   hash-prefix all-to-all k-mer sharding, reduce-scatter
                   merges over a device mesh.
  * ``host``     — the branchy residue: unitig graph, tip/bubble removal,
                   Eulerian traversal, contig emission.
  * ``models``   — the oracle (reference-equivalent) assembler and the
                   pipeline drivers.
"""

from .utils.config import AssemblyConfig
from .utils.dna import canonical_str, decode_seq, encode_seq, revcomp_str

__all__ = [
    "AssemblyConfig",
    "canonical_str",
    "decode_seq",
    "encode_seq",
    "revcomp_str",
]

__version__ = "0.1.0"
