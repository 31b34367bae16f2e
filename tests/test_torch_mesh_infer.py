"""The port's inference over several devices on the CPU: ``generate_batch``,
``beam_search_batch``, ``run_test``, ``DialogueSession`` and the server's
slot axis over a data=2 x model=2 gloo world of spawned processes
(``torch_parallel_worker.mesh_infer_ranks``), K3's and K4's
tensor-parallel forms, and the command line's serving mesh.

One world is spawned once, by a module fixture, while this process runs
the same entry points in one process and ``ergm_tpu``'s over its mesh
on conftest's 8 virtual devices (weights through the HF layout); the
tests below each assert one of the results. Bars: greedy fp32 tokens by
the margin rule (a row is compared up to its first step whose top-2
logit margin in the port's one-process run is at most 1e-3), emotion
logits within 1e-4, sampled tokens equal to the one-process run at the
same seed, the partial forms' sum within 2e-5 of the unsplit plain
version.
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core import mesh as jmesh
from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.infer import beam as jbeam
from ergm_tpu.infer import generate as jgen
from ergm_tpu.infer import server as jserver
from ergm_tpu.models import convert as jconv
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core import mesh as tmesh
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.data.assembly import read_meta
from ergm_tpu_torch.data.dataset import DialogueDataset
from ergm_tpu_torch.data.synthetic import write_synthetic_dataset
from ergm_tpu_torch.infer import beam as tbeam
from ergm_tpu_torch.infer import generate as tgen
from ergm_tpu_torch.infer.interact import DialogueSession, run_repl
from ergm_tpu_torch.infer.runner import run_test
from ergm_tpu_torch.models import convert as tconv
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.ops import cross_decode, fused_decode

import torch_parallel_worker as W

torch.set_num_threads(1)
MARGIN = 1e-3


class Gaps:
    """Records the top-2 logit margin of each row at every ``lm_logits``
    call (a prefill, then each decode step) while in use."""

    def __enter__(self):
        self.real, self.steps = tg.lm_logits, []

        def recorded(params, hidden):
            logits = self.real(params, hidden)
            top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            self.steps.append((top2[:, 0] - top2[:, 1]).numpy())
            return logits
        tg.lm_logits = recorded
        return self

    def __exit__(self, *exc):
        tg.lm_logits = self.real


def margin_equal(want: list, got: list, gaps: list) -> int:
    """``got`` equals ``want`` on each row up to its first decision whose
    margin is at most MARGIN (through the row's end with none). Returns
    the tokens compared."""
    assert len(got) == len(want)
    compared = 0
    for b, row in enumerate(want):
        for j, tok in enumerate(row):
            if j >= len(gaps) or gaps[j][b] <= MARGIN:
                break
            assert j < len(got[b]) and got[b][j] == tok, (b, j, got[b], row)
            compared += 1
        else:
            assert got[b] == row, (b, got[b], row)
    return compared


def _jax_params(pt, tc, jc):
    """The port's weights in JAX's tree (through the HF layout)."""
    return jconv.hf_to_params(tconv.params_to_hf(pt, tc), jc)


# the idle mesh's collective timeout, and how long its rank 0 waits each time
IDLE_S, PG_TIMEOUT_S = 4.0, 2.5


@pytest.fixture(scope="module")
def idle_mesh():
    """The collector of a 2-rank world whose rank 0 waits longer than the
    collective timeout for each REPL line and for an HTTP request
    (``torch_parallel_worker.idle_mesh_ranks``); ``world`` starts it
    first, so that the two overlap."""
    return W.start_world(2, W.idle_mesh_ranks, IDLE_S, PG_TIMEOUT_S)


@pytest.fixture(scope="module")
def world(tmp_path_factory, idle_mesh):
    """The 4-rank world's results, and this process's one-process and JAX
    runs of the same cases (computed while the world runs)."""
    data = str(tmp_path_factory.mktemp("mesh_infer"))
    write_synthetic_dataset(data, prefixes=("valid",), num_dialogues=3, turns_per_dialogue=4,
                            captions="random", seed=3)
    results = W.start_world(4, W.mesh_infer_ranks, data)
    one, jx = {}, {}
    jm = jmesh.make_mesh((2, 2), ("data", "model"))

    tc = W.ModelConfig(**W.GEN)
    pt = tg.params_for_inference(W.init(tc), tc)
    prompts, kw = W.gen_inputs(5)
    with torch.inference_mode():
        with Gaps() as g:
            one["greedy"] = tgen.generate_batch(pt, tc, prompts, greedy=True, **kw, **W.GEN_KW)
        one["greedy_gaps"] = g.steps
        one["sampled"] = tgen.generate_batch(pt, tc, prompts, top_p=0.9,
                                             generator=torch.Generator().manual_seed(3), **kw,
                                             **W.GEN_KW)
        os.environ["ERGM_CROSS_KERNEL"] = "1"
        try:
            prompts8, kw8 = W.gen_inputs(8)
            with Gaps() as g:
                one["kernels"] = tgen.generate_batch(pt, tc.replace(decode_fused_mlp=True),
                                                     prompts8, greedy=True, **kw8, **W.GEN_KW)
            one["kernels_gaps"] = g.steps
        finally:
            del os.environ["ERGM_CROSS_KERNEL"]
    jc = JaxConfig(**W.GEN)
    pj = jmesh.shard_params(jg.params_for_inference(_jax_params(pt, tc, jc), jc), jm)
    jx["greedy"] = jgen.generate_batch(pj, jc, prompts, greedy=True, mesh=jm, **kw, **W.GEN_KW)

    bc = W.ModelConfig(**W.BEAM)
    bp = W.init(bc, seed=3)
    with torch.inference_mode():
        one["beam"] = tbeam.beam_search_batch(bp, bc, W.BEAM_PROMPTS, **W.BEAM_KW)
    jbc = JaxConfig(**W.BEAM)
    jx["beam"] = jbeam.beam_search_batch(jmesh.shard_params(_jax_params(bp, bc, jbc), jm), jbc,
                                         W.BEAM_PROMPTS, mesh=jm, **W.BEAM_KW)

    st = read_meta(data)
    rc = W.ModelConfig(**W.RUN, vocab_size=st.vocab_size)
    ds = DialogueDataset("valid", data, sp1_id=st.sp1_id, sp2_id=st.sp2_id, eos_id=st.eos_id,
                         max_len=128)
    rkw = dict(batch_size=4, eos_id=st.eos_id, sp2_id=st.sp2_id, max_len=128, top_p=0.8,
               seed=2, max_new_tokens=8)
    rp = W.init(rc, seed=4)
    one["run_test"] = tuple(run_test(rp, rc, ds, **rkw))
    one["run_test_beam"] = tuple(run_test(rp, rc, ds, num_beams=2, **rkw))
    tok, tst = W.session_tokenizer()
    scfg = W.ModelConfig(**{**W.RUN, "vocab_size": tst.vocab_size, "use_cross_attention": False})
    session = DialogueSession(W.init(scfg, seed=6), scfg, tst, tok, max_len=64, top_p=0.9,
                              seed=1)
    one["session"] = [session.reply(t, max_new_tokens=8) for t in ("hello there", "how are you")]

    sc = W.ModelConfig(**W.SRV)
    sp = W.init(sc)
    with torch.inference_mode():
        one["server"] = W.serve_greedy(sp, sc, W.server_prompts(8, (6, 13, 9)), None, 2)[1]
        one["server_sampled"] = W.serve_greedy(sp, sc, W.server_prompts(8, (6, 13, 9)), None, 2,
                                               sample=W.SRV_SAMPLE)[1]
        one["spec"] = W.serve_greedy(sp, sc, W.SPEC_PROMPTS, None, 4, sync_every=3,
                                     spec_gamma=3, spec_ngram=2)[1]
        # JAX's oracle_greedy: the server's prompts carry the sp2 type
        one["spec_plain"] = [tgen.generate_batch(sp, sc, [p], greedy=True, spec_mode="none",
                                                 token_types=[[61] * len(p)], max_len=256,
                                                 eos_id=60, sp2_id=61, max_new_tokens=8)[0][0]
                             for p in W.SPEC_PROMPTS]
        one["server_dp4"] = W.serve_greedy(sp, sc, W.server_prompts(9, (6, 13, 9, 17, 5)), None,
                                           4)[1]
        one["features"] = {k: W.serve_greedy(sp, sc, W.FEATURE_PROMPTS, None, 4, **kw_)[1]
                           for k, kw_ in W.SRV_FEATURES.items()}
    jsc = JaxConfig(**W.SRV)
    jsp = _jax_params(sp, sc, jsc)
    srv = jserver.ContinuousServer(jmesh.shard_params(jsp, jm), jsc, slots=2, sync_every=4,
                                   mesh=jm, **W.SRV_KW)
    rids = [srv.submit(jserver.Request(prompt_ids=p, max_new_tokens=8, greedy=True))
            for p in W.server_prompts(8, (6, 13, 9))]
    res = srv.run_until_drained()
    jx["server"] = [res[r].tokens for r in rids]
    jx["server_errors"] = []
    for kw_ in (dict(slots=6), dict(slots=8, long_slots=2)):
        with pytest.raises(ValueError) as e:
            jserver.ContinuousServer(jsp, jsc, mesh=jmesh.make_mesh((4,), ("data",)),
                                     **W.SRV_KW, **kw_)
        jx["server_errors"].append(str(e.value))

    xc = W.ModelConfig.from_model_type("gpt2-xl", **W.XL_KW)
    xp = W.init(xc, seed=5)
    xkw = dict(max_len=32, eos_id=7, sp2_id=5, prompt_bucket=8, max_new_tokens=4)
    with torch.inference_mode(), Gaps() as g:
        one["xl"] = tgen.generate_batch(xp, xc, W.XL_PROMPTS, greedy=True, **xkw)
    one["xl_gaps"] = g.steps
    jxc = JaxConfig.from_model_type("gpt2-xl", **W.XL_KW)
    jx["xl"] = jgen.generate_batch(_jax_params(xp, xc, jxc), jxc, W.XL_PROMPTS, greedy=True,
                                   **xkw)
    del xp
    return results(400), one, jx


# -- generate_batch ------------------------------------------------------------


def test_every_rank_returns_the_whole_batch(world):
    ranks, _, _ = world
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["heads"] for r in ranks} == {2}  # 4 heads over model=2
    for r in ranks[1:]:
        for key in ("greedy", "sampled", "kernels", "beam", "xl"):  # (tokens, emotion logits)
            assert r[key][0] == ranks[0][key][0], key
            np.testing.assert_array_equal(r[key][1], ranks[0][key][1])
        for key in ("server", "server_sampled", "spec", "session"):
            assert r[key] == ranks[0][key], key


@pytest.mark.parametrize("against", ["one process", "ergm_tpu's mesh"])
def test_greedy_generate_batch_matches(world, against):
    """B=5 (padded to 6 over data=2), greedy fp32: tokens by the margin
    rule, emotion logits within 1e-4."""
    ranks, one, jx = world
    want = one["greedy"] if against == "one process" else jx["greedy"]
    got = ranks[0]["greedy"]
    assert margin_equal(want[0], got[0], one["greedy_gaps"]) >= 30
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-4, rtol=0)
    assert got[1].shape == (5, 7)


def test_sampled_generate_batch_matches_one_process(world):
    """Each rank draws the global batch's noise and keeps its rows: the
    sampled tokens equal one process's at the same seed."""
    ranks, one, _ = world
    assert ranks[0]["sampled"][0] == one["sampled"][0]
    np.testing.assert_allclose(ranks[0]["sampled"][1], one["sampled"][1], atol=1e-4, rtol=0)


def test_tensor_parallel_k3_k4_forms_on_the_mesh(world):
    """ERGM_CROSS_KERNEL=1 and decode_fused_mlp at a global batch of 8: every
    rank takes K3's and K4's partial forms (n_layer a step), and the tokens
    equal one process's (the unsplit forms) by the margin rule."""
    ranks, one, _ = world
    for r in ranks:
        forms = r["tp_forms"]
        assert forms["fused_cross_decode_partial_reference"] >= 2 * 8, forms
        assert forms["fused_ln_mlp_partial_reference"] >= 2 * 8, forms
    got = ranks[0]["kernels"]
    margin_equal(one["kernels"][0], got[0], one["kernels_gaps"])
    np.testing.assert_allclose(got[1], one["kernels"][1], atol=1e-4, rtol=0)


# -- beam search, run_test, the REPL -------------------------------------------


@pytest.mark.parametrize("against", ["one process", "ergm_tpu's mesh"])
def test_beam_search_batch_matches(world, against):
    """JAX's test_beam.py:192 case: 3 rows padded to 4, 2 beams."""
    ranks, one, jx = world
    want = one["beam"] if against == "one process" else jx["beam"]
    assert ranks[0]["beam"][0] == want[0]
    np.testing.assert_allclose(ranks[0]["beam"][1], np.asarray(want[1]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("key", ["run_test", "run_test_beam"])
def test_run_test_matches_one_process(world, key):
    """The eval step's losses over the global batch within 1e-5, the
    sampled (seed 2) or beam hypotheses and the predicted labels equal."""
    ranks, one, _ = world
    got, want = ranks[0][key], one[key]
    hyps, refs, labels, losses, preds, contexts, tokens = got
    assert hyps == want[0] and refs == want[1] and labels == want[2]
    assert preds == want[4] and contexts == want[5] and tokens == want[6]
    np.testing.assert_allclose(losses, want[3], atol=1e-5, rtol=0)
    for r in ranks[1:]:
        assert r[key][0] == hyps


def test_dialogue_session_matches_one_process(world):
    """Two sampled turns: rank 0 reads, every rank decodes the same reply."""
    ranks, one, _ = world
    for r in ranks:
        assert r["session"] == one["session"]


# -- the server's slot axis ----------------------------------------------------


def test_server_tp_dp_matches_jax_mesh(world):
    """JAX's tests/test_server.py:284 case: slots=2 over data=2 x model=2."""
    ranks, one, jx = world
    assert ranks[0]["server"] == jx["server"] == one["server"]
    # a rank holds 1 slot of 2 and 2 heads of 4
    assert ranks[0]["server_state"][0][1:3] == (1, 2)
    assert ranks[0]["server_state"][1][0] == 1


def test_server_sampled_rows_match_one_process(world):
    """Sampled requests (top-p 0.9, one seed) through slots=2 over data=2 x
    model=2 give one process's server's tokens: each data rank draws one
    process's decode noise and keeps its rows (``_decode_noise``). They are
    not the greedy tokens."""
    ranks, one, _ = world
    assert ranks[0]["server_sampled"] == one["server_sampled"]
    assert one["server_sampled"] != one["server"]
    assert [len(t) for t in one["server_sampled"]] == [8, 8, 8]


def test_server_data_axis_shards_slots(world):
    """JAX's :302 case: a data-only mesh of 4, one slot a rank."""
    ranks, one, _ = world
    for r in ranks:
        assert r["server_dp4"] == one["server_dp4"]
        assert r["server_dp4_state"][0][1:3] == (1, 4) and r["server_dp4_state"][1][0] == 1


def test_spec_server_over_the_mesh(world):
    """JAX's :459 case: speculative serving over data=2 x model=2 equals one
    process's and plain greedy decoding."""
    ranks, one, _ = world
    assert ranks[0]["spec"] == one["spec"] == one["spec_plain"]


@pytest.mark.parametrize("feature", list(W.SRV_FEATURES))
def test_server_features_over_the_mesh(world, feature):
    """Pipelined blocks, tiered pools (the long one int8 staged) and
    chunked prefill (extension programs over each rank's rows) over
    data=2 x model=2 equal one process."""
    ranks, one, _ = world
    for r in ranks:
        assert r["features"][feature] == one["features"][feature]


@pytest.mark.parametrize("case", [0, 1])
def test_server_divisibility_errors_match_jax(world, case):
    """slots=6 over data=4, and pools of 6 and 2 over data=4: JAX's errors."""
    ranks, _, jx = world
    assert ranks[0]["server_errors"][case] == jx["server_errors"][case]


# -- gpt2-xl's head geometry, the dry run --------------------------------------


@pytest.fixture(scope="module")
def idle_ranks(idle_mesh):
    return idle_mesh(120)


def test_repl_survives_an_idle_mesh(idle_ranks):
    """Rank 0's REPL keeps its follower out of the collective timeout while
    it waits for a line (the idle mark of ``interact._lines``): the replies
    after each wait equal the one-process REPL's."""
    tok, st, cfg, params = W.repl_model()
    out = io.StringIO()
    run_repl(params, cfg, st, tok, max_len=64, top_p=0.9, seed=1,
             stdin=io.StringIO("".join(W.REPL_LINES)), stdout=out)
    assert idle_ranks[0]["repl"] == out.getvalue()
    assert out.getvalue().count("model> ") == len(W.REPL_LINES)


def test_http_front_end_survives_an_idle_mesh(idle_ranks):
    """Rank 0's driver keeps its follower out of the collective timeout
    while no request comes (``ContinuousServer.heartbeat``): after a wait
    longer than the timeout one greedy request gets the one-process
    server's tokens, and the follower stops when the front end closes."""
    sc = W.ModelConfig(**W.SRV)
    with torch.inference_mode():
        want = W.serve_greedy(W.init(sc), sc, [W.IDLE_PROMPT], None, 2)[1][0]
    assert idle_ranks[0]["http"]["tokens"] == want
    assert idle_ranks[1]["followed_s"] > IDLE_S


def test_xl_geometry_over_model_2_matches_jax(world):
    """25 heads of 64 (D=1600) at 2 layers: 13 and 12 heads a model rank;
    greedy fp32 tokens against JAX's single device by the margin rule."""
    ranks, one, jx = world
    assert sorted(r["xl_heads"] for r in ranks) == [12, 12, 13, 13]
    margin_equal(jx["xl"][0], ranks[0]["xl"][0], one["xl_gaps"])
    margin_equal(one["xl"][0], ranks[0]["xl"][0], one["xl_gaps"])
    np.testing.assert_allclose(ranks[0]["xl"][1], np.asarray(jx["xl"][1]), atol=1e-4, rtol=0)


def test_dryrun_multichip(world):
    """dryrun_multichip(4): a ZeRO-1 step over (2, 2), a greedy decode over
    the mesh, gpt2-xl's geometry; the same readings on every rank."""
    ranks, _, _ = world
    got = ranks[0]["dryrun"]
    assert np.isfinite(got["loss"]) and np.isfinite(got["xl_loss"])
    assert got["mesh"] == {"data": 2, "model": 2} and min(got["lengths"]) >= 16
    assert got["zero1_sharded"][0] * 2 >= got["zero1_sharded"][1]
    for r in ranks[1:]:
        assert r["dryrun"]["loss"] == got["loss"] and r["dryrun"]["lengths"] == got["lengths"]


# -- K3's and K4's partial forms, one process ----------------------------------


def _split_block(blk, cfg, parts: int):
    """Each model rank's part of one block (``split_model``'s rule)."""
    out = []
    for r in range(parts):
        mesh = tmesh.make_mesh((1, parts), ("data", "model"), world_size=parts, rank=r)
        part = tg.Block(cfg, device="cpu")
        with torch.no_grad():
            for name, p in blk.named_parameters():
                local = tmesh.split_model(f"blocks.0.{name}", p.detach(), cfg, mesh)
                mod, leaf = name.rsplit(".", 1)
                setattr(part.get_submodule(mod), leaf, torch.nn.Parameter(local.clone()))
        out.append((part, mesh))
    return out


@pytest.mark.parametrize("n_embd,n_head,parts", [(128, 4, 2), (320, 5, 2), (768, 12, 3)])
def test_k3_partial_forms_sum_to_the_unsplit_sublayer(n_embd, n_head, parts):
    """The partials of each rank's heads, summed, then the bias, the
    capless-row gate and the residual: the unsplit plain sublayer within
    2e-5 (fp32; 5 heads over 2 go 3/2)."""
    cfg = W.ModelConfig(n_layer=1, n_embd=n_embd, n_head=n_head, vocab_size=64, dtype="float32",
                        cross_kv_dtype="int8")
    blk = W.init(cfg).blocks[0]
    rng = np.random.default_rng(0)
    B, Lc = 8, 6
    h = torch.as_tensor(rng.standard_normal((B, 1, n_embd)).astype(np.float32))
    enc = torch.as_tensor(rng.standard_normal((B, Lc, n_embd)).astype(np.float32))
    mask = torch.as_tensor((np.arange(Lc)[None] < rng.integers(0, Lc + 1, (B, 1))).astype(
        np.float32))
    scale = 0.125

    def stacks(b, mesh=None):
        km, vm = tg.dense(enc, b.cross_attn.c_attn).chunk(2, dim=-1)
        c = tg.init_kv_cache(cfg, B, 4, caption_len=Lc, device="cpu", mesh=mesh)
        tg._write_cross_cache(c, 0, km, vm, cfg)
        return (c.ck, c.cv, c.ck_scale, c.cv_scale)

    with torch.inference_mode():
        want = cross_decode.fused_cross_decode_reference(h, blk, 0, scale, stacks(blk), mask,
                                                         cfg)
        total = sum(cross_decode.fused_cross_decode_partial(h, part, 0, scale, stacks(part, mesh),
                                                            mask, cfg)
                    for part, mesh in _split_block(blk, cfg, parts))
        got = fused_decode.finish_partial(h, total, blk.cross_attn.c_proj.bias, mask)
    assert total.dtype == torch.float32 and total.shape == (B, 1, n_embd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("n_embd,n_head,parts", [(128, 4, 2), (768, 12, 2), (768, 12, 3)])
def test_k4_partial_forms_sum_to_the_unsplit_mlp(n_embd, n_head, parts):
    """Each rank's F/parts columns through LN2, c_fc and the GELU, its rows
    of c_proj: the partials summed, then the bias and the residual, equal
    the unsplit plain decode tail within 2e-5 (fp32)."""
    cfg = W.ModelConfig(n_layer=1, n_embd=n_embd, n_head=n_head, vocab_size=64, dtype="float32")
    blk = W.init(cfg).blocks[0]
    h = torch.as_tensor(np.random.default_rng(1).standard_normal((8, 1, n_embd)).astype(
        np.float32))
    with torch.inference_mode():
        want = fused_decode.fused_ln_mlp_reference(h, blk.ln_2, blk.mlp, cfg)
        total = sum(fused_decode.fused_ln_mlp_partial(h, part.ln_2, part.mlp, cfg)
                    for part, _ in _split_block(blk, cfg, parts))
        got = fused_decode.finish_partial(h, total, blk.mlp.c_proj.bias)
    assert fused_decode.supported(h, blk.mlp, cfg, 8, parts) == (cfg.inner_dim // parts % 64 == 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


# -- the command line ----------------------------------------------------------


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """A tiny checkpoint trained through the port's CLI, then ``--mode=infer``
    with ``--mesh_shape=1`` in this process and with ``--mesh_shape=2
    --gpu=cpu`` (two processes over gloo) in a subprocess: (the first run's
    generations, the second's, the second's output)."""
    from ergm_tpu_torch.cli import main as cli
    from ergm_tpu_torch.core import config as port_config

    tmp = tmp_path_factory.mktemp("cli")
    write_synthetic_dataset(str(tmp / "tiny"), prefixes=("train", "valid"), num_dialogues=4,
                            turns_per_dialogue=4, base_vocab_size=200, seed=3)
    tiny = dict(n_layer=2, n_embd=64, n_head=2)
    common = [f"--data_dir={tmp}", "--model_type=tiny", "--batch_size=4", "--max_len=64",
              "--dtype=float32", "--gpu=cpu", "--valid_prefix=valid", f"--ckpt_dir={tmp}/ck"]
    infer = ["--mode=infer", "--ckpt_name=best", "--top_p=0.8", "--seed=3", *common]
    path = tmp / "tiny" / "best_generations.txt"
    saved = port_config.GPT2_SIZES.get("tiny")
    port_config.GPT2_SIZES["tiny"] = tiny
    try:
        cli.main(["--mode=train", "--num_epochs=1", "--lr=1e-3", "--output_dir=",
                  "--mesh_shape=1", *common])
        cli.main([*infer, "--mesh_shape=1"])
    finally:
        if saved is None:
            del port_config.GPT2_SIZES["tiny"]
        else:
            port_config.GPT2_SIZES["tiny"] = saved
    single = path.read_text()
    path.unlink()
    script = tmp / "run_cli.py"
    script.write_text(f"import sys\nimport ergm_tpu_torch.core.config as c\n"
                      f"c.GPT2_SIZES['tiny'] = {tiny!r}\n"
                      f"from ergm_tpu_torch.cli.main import main\n"
                      f"if __name__ == '__main__':\n    main(sys.argv[1:])\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(__file__)),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, str(script), *infer, "--mesh_shape=2"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return single, path.read_text(), out.stdout


def test_cli_infer_over_a_two_rank_mesh(cli_runs):
    """JAX's tests/test_cli.py:102-124 form: ``--mode=infer --mesh_shape=2
    --gpu=cpu`` (two processes over gloo, rank 0 writes) writes the
    generations of ``--mesh_shape=1``."""
    single, meshed, stdout = cli_runs
    assert "world: 2 ranks" in stdout and "Serving over mesh {'data': 2}" in stdout
    assert stdout.count("Final Evaluation Results") == 1  # rank 0 alone prints
    assert "GPT-2:" in single and meshed == single
