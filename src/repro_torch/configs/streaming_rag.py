"""The paper's own system config (Table 2 defaults): the streaming-RAG
pipeline and its SBERT-style embedder, registered as
``streaming-rag-embedder`` so the launchers share one entry point."""
from __future__ import annotations

from repro_torch.core import clustering, heavy_hitter, pipeline, prefilter
from repro_torch.models.api import register
from repro_torch.models.transformer import EncoderConfig, EncoderEmbedder

EMBED_DIM = 384


def paper_pipeline_config(
    *,
    dim: int = EMBED_DIM,
    k: int = 100,               # MiniBatchKMeans clusters (Table 2)
    capacity: int = 100,        # heavy-hitter counters B
    alpha: float = 0.2,         # relevance threshold
    admit_prob: float = 0.05,   # u
    basis: str = "fixed",       # 5 Gram–Schmidt topic vectors
    policy: heavy_hitter.Policy = heavy_hitter.Policy.MIN_EVICT,
    morris: bool = False,
    update_interval: int = 1000,
    adaptive: bool = False,
    store_depth: int = 0,       # per-cluster doc ring (two-stage opts in)
    store_dtype: str = "fp32",  # ring precision: fp32 or int8
) -> pipeline.PipelineConfig:
    return pipeline.PipelineConfig(
        pre=prefilter.PrefilterConfig(
            num_vectors=5, dim=dim, alpha=alpha, basis=basis,
            window=1000, update_interval=1000),
        clus=clustering.ClusterConfig(num_clusters=k, dim=dim,
                                      update_mode="batched"),
        hh=heavy_hitter.HHConfig(
            capacity=capacity, admit_prob=admit_prob, policy=policy,
            morris=morris, adaptive=adaptive,
            max_capacity=2 * capacity if adaptive else None),
        update_interval=update_interval,
        store_depth=store_depth,
        store_dtype=store_dtype,
    )


@register("streaming-rag-embedder")
def make_embedder(smoke: bool = False):
    if smoke:
        return EncoderEmbedder(EncoderConfig(
            name="sbert-encoder-smoke", n_layers=2, d_model=32, n_heads=2,
            d_ff=64, vocab=128, max_len=16))
    # ~26M params (6 x 2.36M + the 30,522 x 384 tied embedding), MiniLM-ish:
    # the embedding producer for the pipeline
    return EncoderEmbedder(EncoderConfig(
        name="sbert-encoder", n_layers=6, d_model=EMBED_DIM, n_heads=6,
        d_ff=1536, vocab=30522, max_len=128))
