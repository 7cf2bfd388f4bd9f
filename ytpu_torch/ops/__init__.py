"""Device programs: decode, integrate (CUDA kernel), compaction."""
