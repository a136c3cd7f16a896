"""The tensor-parallel serving engine: a gloo world of 2 (a mesh
``{"tp": 2}``) serving a ragged batch through ``tp_axis="tp"``, against
the port's dense engine on the same weights and the JAX package's
``tp_axis`` engine on a 2-device mesh, f32 on the CPU: greedy tokens
identical on every rank. Each forward pass makes exactly two all-reduces
a block (the ``psum``\\ s of ``tp_block_apply``), plus one all-gather for
a feature-split embedding and one for a vocabulary-split ``lm_head``;
the scheduler (the control plane, replicated on every rank) makes none.
"""

import numpy as np
import pytest
import jax

import horovod_tpu as jhvd
import horovod_tpu.serving as jserving
from horovod_tpu_torch.testing import run_world

import torch_serving_helpers as H
import torch_serving_workers as SW

pytestmark = pytest.mark.torch_port

KW = dict(page_size=8, num_pages=40, max_batch=3, prefill_chunk=8,
          max_seq_len=32)
#: model cases: (kwargs of the JAX model, embedding split, lm_head split)
CASES = {
    # vocab 97 is odd: lm_head stays whole, as in the JAX package
    "learned_mha": (dict(), True, False),
    "rope_gqa_vocab_split": (dict(pos="rope", kv_heads=2, vocab=98), True,
                             True),
}


def _cfg(jm):
    return dict(vocab=jm.vocab, dim=jm.dim, depth=jm.depth, heads=jm.heads,
                kv_heads=jm.kv_heads, mlp_ratio=jm.mlp_ratio,
                max_len=jm.max_len, pos_embedding=jm.pos_embedding)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_matches_dense_and_jax(case):
    model_kw, embed_split, head_split = CASES[case]
    jm = H.jax_model(**model_kw)
    p = H.params(jm)
    prompts = H.ragged_prompts(42, (5, 11, 3, 8, 14), vocab=jm.vocab)
    jhvd.init(devices=jax.devices()[:2], axes={"tp": 2})
    try:
        e = jserving.InferenceEngine(jm, tp_axis="tp", **KW)
        e.set_weights(p, generation=1)
        reqs = [e.submit(x, 6, rid=f"r{i}") for i, x in enumerate(prompts)]
        e.run_until_idle()
        want = [list(map(int, r.generated)) for r in reqs]
    finally:
        jhvd.shutdown()
    out = run_world(SW.tp_engine_worker, 2, p, prompts, 6, _cfg(jm), KW)
    for r in out:
        assert r["tp"] == want
        assert r["dense"] == want
        assert r["dense_calls"] == 0 and r["control_calls"] == 0
        per = 2 * jm.depth
        gathers = int(embed_split) + int(head_split)
        # every forward: 2 all-reduces a block, the split tables' gathers
        assert r["tp_calls"].get("all_reduce", 0) % per == 0
        passes = r["tp_calls"]["all_reduce"] // per
        assert passes >= 6
        got = sum(v for k, v in r["tp_calls"].items() if k != "all_reduce")
        assert got == gathers * passes
        assert set(r["tp_calls"]) <= {"all_reduce", "all_gather_single",
                                      "all_gather_into_tensor"}
    assert out[0]["per_pass"] == out[1]["per_pass"]
