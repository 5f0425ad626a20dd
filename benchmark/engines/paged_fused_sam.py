"""``fused_sam.PagedBatchedFusedSamEngine`` as ``server.build_server_engine``
builds it for ``--engine paged_fused_sam``: ``FusedSamConfig(
steps_per_call=16, n_predicts=15)`` (block M = 16), over a pool of int8 KV
pages (``quantized_kv``), with the port's default routes (K3 for int4
products, the verify kernel, K4).  The end token is off (-1, as the server
gives a random model), so every request decodes its whole budget."""

from __future__ import annotations

from typing import Dict, List, Optional


def build(model_cfg, params, serving: Dict, corpus: Optional[List[int]],
          device):
    from samd_tpu_torch.fused_sam import (FusedSamConfig,
                                          PagedBatchedFusedSamEngine)

    fs = FusedSamConfig(steps_per_call=serving["steps_per_call"],
                        n_predicts=serving["n_predicts"],
                        corpus_capacity=serving["corpus_capacity"])
    return PagedBatchedFusedSamEngine(
        model_cfg, params, fs, corpus=corpus,
        batch_size=serving["batch_size"],
        max_cache_len=serving["max_cache_len"], eos_token_id=-1,
        prefill_buckets=tuple(serving["prefill_buckets"]), device=device,
        n_pages=serving["n_pages"], page_size=serving["page_size"],
        quantized_kv=serving["quantized_kv"])
