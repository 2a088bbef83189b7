"""Streaming engine: stage-decomposed ingest/query over one state.

``stages`` — the composable ingest and query stages.
``engine`` — the single-device composition and the ``Engine`` object the
             server is built on.
``plan``   — runtime retrieval effort (``QueryPlan``, ``PlanSpace``).
"""
