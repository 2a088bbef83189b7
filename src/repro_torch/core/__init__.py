"""Streaming RAG core — the paper's primary contribution in PyTorch.

Pipeline stages (Algorithm 1):
  prefilter    — multi-vector cosine screening (fixed / random / adaptive PCA)
  clustering   — streaming mini-batch k-means prototypes
  heavy_hitter — bounded counter filter (4 eviction policies, Morris, adaptive)
  index        — incremental-upsert MIPS index (+ IVF-PQ baseline)
  pipeline     — fused per-microbatch ingest + query path
  baselines    — the paper's six comparison strategies
  theory       — E[R(K_t)] >= R* − L·Δ empirical validation
"""
