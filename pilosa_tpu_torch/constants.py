"""Global constants for pilosa_tpu.

Mirrors the reference's operational envelope (see
reference fragment.go:48,60,63 and field.go:38-41, cluster.go:40) but
re-expressed for a TPU bitplane layout: a shard is 2^20 columns wide and the
device-side unit of compute is a dense row bitplane of SHARD_WIDTH bits packed
into 32-bit lanes.
"""

import os

# Width of a single shard, in columns (reference: fragment.go:48 ShardWidth).
# Overridable for tests that want tiny device tensors.
SHARD_WIDTH_EXP = int(os.environ.get("PILOSA_TPU_SHARD_WIDTH_EXP", "20"))
SHARD_WIDTH = 1 << SHARD_WIDTH_EXP

# Device bitplane packing: uint32 lanes (population_count-supported on TPU).
BITS_PER_WORD = 32
WORDS_PER_ROW = SHARD_WIDTH // BITS_PER_WORD

# TopN cache (reference: field.go:38-41).
DEFAULT_CACHE_SIZE = 50000
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_NONE = "none"

# Field types (reference: field.go:49-53).
FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"

DEFAULT_FIELD_TYPE = FIELD_TYPE_SET

# Snapshot after this many incremental ops (reference: fragment.go:63).
MAX_OP_N = 2000

# Merkle/anti-entropy hash block size, in rows (reference: fragment.go:60).
HASH_BLOCK_SIZE = 100

# Cluster partitioning (reference: cluster.go:40).
DEFAULT_PARTITION_N = 256

# Max writes allowed in a single /query request (reference: server/config.go:107).
MAX_WRITES_PER_REQUEST = 5000

# View names (reference: view.go:31-35).
VIEW_STANDARD = "standard"
VIEW_BSI_GROUP_PREFIX = "bsig_"

# Time quantum characters, in order (reference: time.go).
TIME_QUANTUM_CHARS = "YMDH"
