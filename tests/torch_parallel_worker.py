"""The ranks' side of ``tests/test_torch_parallel.py``: functions that run
in every process of a gloo world on the CPU (``run_world``) and return
plain, picklable results. This module imports torch and the port only,
so a spawned rank starts in a few seconds."""
from __future__ import annotations

import multiprocessing
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.mesh import (batch_rows, gather_model, make_mesh, shard_opt_state,
                                      shard_params, split_model, zero1_sharding_tree)
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.ops import fused_ce
from ergm_tpu_torch.parallel import distributed
from ergm_tpu_torch.train import checkpoint as ckpt
from ergm_tpu_torch.train import steps

# the data-parallel cases' model: 2 layers, 4 heads, tri-modal, K5's and
# K6's plain versions ("block", "fused")
TINY = dict(n_layer=2, n_embd=64, n_head=4, vocab_size=256, n_positions=128, modality_dim=64,
            dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
            attention_impl="block", lm_loss_impl="fused", remat=False)
# gpt2's head geometry (12 x 64) at test depth, dropout on
GPT2_TP = dict(TINY, n_layer=2, n_embd=768, n_head=12, vocab_size=128, modality_dim=768,
               embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1, lm_loss_impl="auto",
               remat=True, remat_policy="mlp")
B, L, LC, STEPS, LR = 4, 128, 32, 8, 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, n, port, queue, fn, args):
    torch.set_num_threads(1)
    try:
        distributed.initialize(f"127.0.0.1:{port}", 1, 0, local_rank=rank, local_world_size=n,
                               device="cpu")
        queue.put((rank, fn(rank, *args)))
    except BaseException:  # noqa: BLE001 - the parent reports it
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        distributed.shutdown()


def run_world(n: int, fn, *args, timeout: float = 240) -> list:
    """``fn(rank, *args)`` in each of ``n`` spawned processes joined over
    gloo; returns their results in rank order (raises on any failure)."""
    return start_world(n, fn, *args)(timeout)


def start_world(n: int, fn, *args):
    """``run_world`` without the wait: starts the processes and returns
    ``results(timeout)``, which collects them (the caller works meanwhile)."""
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=_entry, args=(r, n, port, queue, fn, args)) for r in range(n)]
    for p in procs:
        p.start()
    return lambda timeout=240: _collect(procs, queue, timeout)


def _collect(procs, queue, timeout: float) -> list:
    out = {}
    try:
        for _ in procs:
            rank, res = queue.get(timeout=timeout)
            if isinstance(res, dict) and "error" in res:
                raise RuntimeError(f"rank {rank}:\n{res['error']}")
            out[rank] = res
    finally:
        for p in procs:
            p.join(10)
            if p.exitcode is None:
                p.kill()
    return [out[r] for r in range(len(procs))]


def batches(seed: int, n: int, vocab: int = 256, b: int = B, lc: int = LC) -> list:
    """``n`` global batches with rows of very unequal target counts (rows
    0 and 1 have 96, row 2 has 8) and a fill row (the last): the two data
    ranks hold 192 and 8 targets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, L))
        labels = ids.copy()
        labels[:, :L // 4] = -100
        labels[b // 2, :L - 8] = -100
        cap = (np.arange(lc)[None] < rng.integers(0, lc + 1, (b, 1))).astype(np.float32)
        batch = dict(input_ids=ids, token_type_ids=rng.integers(0, vocab, (b, L)), labels=labels,
                     emotion_labels=rng.integers(0, 7, (b,)), valid=np.arange(b) < b - 1,
                     seq_lengths=rng.integers(L // 2, L + 1, (b,)),
                     imgs=rng.standard_normal((b, 64 if vocab == 256 else 768)).astype(np.float32),
                     auds=rng.standard_normal((b, 64 if vocab == 256 else 768)).astype(np.float32),
                     caption_ids=rng.integers(0, vocab, (b, lc)), caption_mask=cap)
        out.append({k: torch.as_tensor(v).long() if np.asarray(v).dtype.kind in "iu"
                    else torch.as_tensor(v) for k, v in batch.items()})
    return out


def rows_of(batch: dict, mesh) -> dict:
    lo, hi = batch_rows(len(batch["valid"]), mesh)
    return {k: v[lo:hi] for k, v in batch.items()}


def init(cfg: ModelConfig, seed: int = 0) -> gpt2.GPT2:
    """A random init with non-trivial biases and LayerNorm parameters."""
    params = gpt2.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return params


def grads_of(params, cfg, batch, mesh=None, seed=3) -> tuple:
    """(loss, metrics, {name: gradient}) of one forward and backward; over
    a mesh the gradients are summed over the data axis."""
    for p in params.parameters():
        p.grad = None
    loss, m = steps._losses_and_metrics(params, cfg, rows_of(batch, mesh) if mesh else batch,
                                        deterministic=False, seed=seed, mesh=mesh)
    loss.backward()
    named = list(params.named_parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in named]
    if mesh is not None and mesh.group("data") is not None:
        steps.all_reduce_(grads, mesh.group("data"))
    return float(loss.detach()), {k: float(v) for k, v in m.items()}, {n: g for (n, _), g in zip(named,
                                                                                        grads)}


def _max_err(got: dict, want: dict, cfg, mesh) -> float:
    """The largest |got - want| over every parameter's gradient, ``want``
    the whole gradient cut to this rank's part."""
    return max(float((g - split_model(n, want[n], cfg, mesh)).abs().max())
               for n, g in got.items())


def train(params, cfg, batches_, mesh=None, zero=False, mu_dtype=None, accumulate=1) -> tuple:
    """AdamW steps over ``batches_``: (losses, state)."""
    tx = steps.AdamW(LR, mu_dtype=mu_dtype, accumulate=accumulate)
    state = steps.create_train_state(params, tx)
    dims = None
    if zero:
        dims = zero1_sharding_tree(params, mesh)
        shard_opt_state(state.opt_state, mesh, dims)
    step = steps.make_train_step(cfg, tx, device="cpu", mesh=mesh, opt_shardings=dims)
    losses = []
    for b in batches_:
        state, m = step(state, rows_of(b, mesh) if mesh else b, 7)
        losses.append(float(m["loss"]))
    return losses, state, tx


def whole_params(params, cfg, mesh) -> dict:
    """Every parameter whole (the model axis's shards gathered), as numpy."""
    return {n: (gather_model(n, p.detach(), cfg, mesh) if mesh else p.detach()).numpy().copy()
            for n, p in params.named_parameters()}


# -- the 2-rank world --------------------------------------------------------


DP_CASES = {"fused": {}, "chunked": {"lm_loss_impl": "chunked"},
            "zero1": {"zero": True}, "zero1 bf16 mu": {"zero": True, "mu_dtype": torch.bfloat16},
            "accumulate 2": {"accumulate": 2}}


def two_ranks(rank: int, root: str) -> dict:
    out = {"dp": {}}
    mesh = make_mesh((2,), ("data",))
    data = batches(0, STEPS)
    for name, case in DP_CASES.items():
        cfg = ModelConfig(**{**TINY, **{k: v for k, v in case.items() if k == "lm_loss_impl"}})
        opts = {k: v for k, v in case.items() if k != "lm_loss_impl"}
        l1, _, g1 = grads_of(init(cfg), cfg, data[0])
        l2, m2, g2 = grads_of(init(cfg), cfg, data[0], mesh)
        single_losses, s_state, _ = train(init(cfg), cfg, data,
                                          **{k: v for k, v in opts.items() if k != "zero"})
        mesh_losses, m_state, _ = train(init(cfg), cfg, data, mesh=mesh, **opts)
        res = {"loss": (l1, l2), "grad_err": _max_err(g2, g1, cfg, mesh),
               "steps": (single_losses, mesh_losses),
               "param_err": max(float(np.abs(a - b).max()) for a, b in zip(
                   whole_params(s_state.params, cfg, None).values(),
                   whole_params(m_state.params, cfg, mesh).values())),
               "metrics": m2}
        if name == "fused":
            # a mean of per-rank means, what the invariant rules out
            p = init(cfg)
            local = rows_of(data[0], mesh)
            with torch.no_grad():
                h, _ = gpt2.transformer(p, cfg, local["input_ids"],
                                        token_type_ids=local["token_type_ids"],
                                        imgs=local["imgs"], auds=local["auds"],
                                        caption_ids=local["caption_ids"],
                                        encoder_attention_mask=local["caption_mask"])
                labels = torch.where(local["valid"][:, None], local["labels"], -100)
                mean = fused_ce.fused_lm_loss(h, gpt2.wte_dense(p.wte, h.dtype), labels)
                dist.all_reduce(mean)
                res["mean_of_means"] = float(mean) / 2
                hf, _ = gpt2.transformer(p, cfg, data[0]["input_ids"],
                                         token_type_ids=data[0]["token_type_ids"],
                                         imgs=data[0]["imgs"], auds=data[0]["auds"],
                                         caption_ids=data[0]["caption_ids"],
                                         encoder_attention_mask=data[0]["caption_mask"])
                lf = torch.where(data[0]["valid"][:, None], data[0]["labels"], -100)
                res["lm_single"] = float(fused_ce.fused_lm_loss(
                    hf, gpt2.wte_dense(p.wte, hf.dtype), lf))
                res["lm_sharded"] = float(fused_ce.fused_lm_loss_sharded(
                    h, gpt2.wte_dense(p.wte, h.dtype), labels, mesh))
        out["dp"][name] = res

    # tensor parallelism at gpt2's head geometry, dropout on
    cfg = ModelConfig(**GPT2_TP)
    tp = make_mesh((1, 2), ("data", "model"))
    data_tp = batches(1, 1, vocab=128, b=2, lc=32)
    l1, _, g1 = grads_of(init(cfg), cfg, data_tp[0])
    l2, _, g2 = grads_of(shard_params(init(cfg), tp), cfg, data_tp[0], tp)
    out["tp"] = {"loss": (l1, l2), "grad_err": _max_err(g2, g1, cfg, tp),
                 "errors": {n: float((g - split_model(n, g1[n], cfg, tp)).abs().max())
                            for n, g in g2.items()},
                 "split": [n for n in g2 if g2[n].shape != g1[n].shape]}

    # checkpoints across meshes: the world (ZeRO-1) saves after 2 steps,
    # resumes its own save, and restores the single process's
    cfg = ModelConfig(**TINY)
    first, rest = data[:2], data[2:3]
    _, state, tx = train(init(cfg), cfg, first, mesh=mesh, zero=True)
    p2 = whole_params(state.params, cfg, mesh)
    ckpt.save_checkpoint(f"{root}/world", state, 1, 10.0, mesh=mesh)
    step = steps.make_train_step(cfg, tx, device="cpu", mesh=mesh, opt_shardings=state.opt_state.zero.dims)
    state, m = step(state, rows_of(rest[0], mesh), 7)
    ahead = (float(m["loss"]), whole_params(state.params, cfg, mesh))
    out["ckpt"] = {"p2": p2, "loss3": ahead[0]}
    resumed = {}
    for src in ("world", "single"):
        _, fresh, tx = train(init(cfg, seed=9), cfg, [], mesh=mesh, zero=True)
        path = ckpt.find_checkpoint(f"{root}/{src}")
        ckpt.restore_checkpoint(path, fresh, mesh=mesh)
        params, opt = ckpt._gathered(fresh, False, mesh)
        resumed[src] = {"params": {k: v.numpy().copy() for k, v in params.items()},
                        "mu": [e["exp_avg"].numpy().copy() for e in opt["state"].values()],
                        "nu": [e["exp_avg_sq"].numpy().copy() for e in opt["state"].values()]}
        step = steps.make_train_step(cfg, tx, device="cpu", mesh=mesh,
                                     opt_shardings=fresh.opt_state.zero.dims)
        fresh, m = step(fresh, rows_of(rest[0], mesh), 7)
        resumed[src].update(step=int(fresh.step), loss=float(m["loss"]),
                            after=whole_params(fresh.params, cfg, mesh))
    out["ckpt"]["resumed"] = resumed
    out["ckpt"]["ahead"] = ahead[1]
    return out if rank == 0 else {"dp": {k: {"grad_err": v["grad_err"]} for k, v in
                                         out["dp"].items()},
                                  "tp": {"errors": out["tp"]["errors"]}}


# -- the 4-rank world --------------------------------------------------------


def four_ranks(rank: int, xl_npz: str, xl_kw: dict) -> dict:
    from ergm_tpu_torch.models.convert import params_from_numpy

    out = {}
    # gpt2-xl's head geometry (25 x 64) over model=4: heads 7/6/6/6
    cfg = ModelConfig(**xl_kw)
    with np.load(xl_npz) as z:
        tree = {}
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    xl = make_mesh((1, 4), ("data", "model"))
    params = shard_params(params_from_numpy(tree, cfg, device="cpu"), xl)
    del tree
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 128, (4, 32)))
    emo = torch.as_tensor(rng.integers(0, 7, (4,)))
    o = gpt2.forward(params, cfg, ids, labels=ids, emotion_labels=emo, mesh=xl)
    o.loss.backward()
    out["xl"] = {"loss": float(o.loss.detach()), "heads": params.blocks[0].attn.c_attn.kernel.shape[1] // 192,
                 "finite": all(bool(torch.isfinite(p.grad).all()) for p in params.parameters()
                               if p.grad is not None)}
    del params, o

    # data=2 x model=2 with ZeRO-1: one step against one process
    cfg = ModelConfig(**{**TINY, "lm_loss_impl": "chunked"})
    mesh = make_mesh((2, 2), ("data", "model"))
    data = batches(2, 1)
    single, s_state, _ = train(init(cfg), cfg, data)
    meshed, m_state, _ = train(shard_params(init(cfg), mesh), cfg, data, mesh=mesh, zero=True)
    _, _, g1 = grads_of(init(cfg), cfg, data[0])
    _, _, g2 = grads_of(shard_params(init(cfg), mesh), cfg, data[0], mesh)
    out["dp2xmp2"] = {"loss": (single[0], meshed[0]), "grad_err": _max_err(g2, g1, cfg, mesh),
                      "param_err": max(float(np.abs(a - b).max()) for a, b in zip(
                          whole_params(s_state.params, cfg, None).values(),
                          whole_params(m_state.params, cfg, mesh).values())),
                      "zero_sharded": sum(d is not None for d in m_state.opt_state.zero.dims)}
    try:
        h = torch.zeros((2, 8, 64))
        fused_ce.fused_lm_loss_sharded(h, torch.zeros((256, 64)), torch.zeros((2, 8)).long(),
                                       mesh)
        out["sharded_raises"] = False
    except ValueError as e:
        out["sharded_raises"] = "pure 'data' mesh" in str(e)

    # per-site dropout masks: one per rank, gathered
    seed = gpt2._site(1234, 2, mesh.index("data"))
    mask = gpt2._dropout(torch.ones((4, 16, 32)), 0.5, seed) > 0
    got = [torch.empty_like(mask, dtype=torch.uint8) for _ in range(4)]
    dist.all_gather(got, mask.to(torch.uint8))
    out["masks"] = [g.numpy() for g in got]
    out["coords"] = (mesh.index("data"), mesh.index("model"))
    return out


# -- inference over a mesh (tests/test_torch_mesh_infer.py) --------------------

# generate_batch's model: tri-modal, int8 self and cross caches; D % 128
# and 2 heads of 32 a model rank, so that with the decode switches on K3's
# and K4's tensor-parallel forms are taken (at a global batch of 8)
GEN = dict(n_layer=2, n_embd=128, n_head=4, vocab_size=128, n_positions=64, modality_dim=64,
           dtype="float32", kv_cache_dtype="int8", cross_kv_dtype="int8")
GEN_KW = dict(max_len=48, eos_id=7, sp2_id=5, prompt_bucket=16, caption_bucket=8,
              max_new_tokens=12)
# JAX's beam (tests/test_beam.py:192) and server (tests/test_server.py) models
BEAM = dict(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4,
            use_cross_attention=False, dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
            resid_pdrop=0.0)
BEAM_PROMPTS = [[1, 8, 3], [2, 5, 9, 11], [7, 4]]  # 3 rows -> padded to 4
BEAM_KW = dict(num_beams=2, max_len=24, eos_id=60, sp2_id=61, max_new_tokens=5)
SRV = dict(BEAM, n_positions=256)
SRV_KW = dict(eos_id=60, sp2_id=61, max_prompt=32, prompt_bucket=16)
# gpt2-xl's head geometry at 2 layers (25 heads: 13/12 over model=2)
XL_KW = dict(n_layer=2, vocab_size=128, n_positions=64, dtype="float32",
             use_cross_attention=False)
XL_PROMPTS = [[3, 9, 27, 81, 5], [11, 13, 17]]
# run_test's model over the synthetic corpus
RUN = dict(n_layer=2, n_embd=64, n_head=4, n_positions=128, dtype="float32", modality_dim=768)


def gen_inputs(b: int) -> tuple:
    """``b`` ragged prompts with token types, captions (a caption-less row
    among them), image and audio features."""
    rng = np.random.default_rng(b)
    prompts = [rng.integers(10, 120, (int(n),)).tolist() for n in rng.integers(3, 14, b)]
    caps = [rng.integers(10, 120, (int(n),)).tolist() or None for n in rng.integers(0, 7, b)]
    caps[1] = None
    feats = rng.standard_normal((b, 64)).astype(np.float32)
    tts = [[5 if j % 2 else 6 for j in range(len(p))] for p in prompts]
    return prompts, dict(captions=caps, imgs=feats, auds=feats[::-1].copy(), token_types=tts)


def server_prompts(seed: int, lens) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50, (n,)).tolist() for n in lens]


# the server's other paths over the mesh: pipelined blocks, tiers (the long
# pool int8 staged) and chunked prefill (extension programs)
SRV_FEATURES = {"pipeline": dict(pipeline=True),
                "tiers": dict(long_slots=2, long_threshold=20),
                "chunks": dict(prefill_chunk=16)}
FEATURE_PROMPTS = server_prompts(10, (6, 13, 9, 17, 5, 30))
SPEC_PROMPTS = (server_prompts(12, (6, 13, 9))
                + [np.random.default_rng(13).integers(0, 50, (4,)).tolist() * 4])


def serve_greedy(params, cfg, prompts, mesh, slots, max_new=8, sample=None, **kw):
    """JAX's ``_serve_greedy``: greedy requests through the server, or
    sampled ones with ``sample`` = (top_p, seed); only rank 0 submits over
    a mesh. Returns (server, tokens in order)."""
    from ergm_tpu_torch.infer.server import ContinuousServer, Request

    srv = ContinuousServer(params, cfg, slots=slots, mesh=mesh, **{"sync_every": 4, **SRV_KW,
                                                                   **kw})
    how = (dict(greedy=True) if sample is None
           else dict(greedy=False, top_p=sample[0], seed=sample[1]))
    rids = ([srv.submit(Request(prompt_ids=p, max_new_tokens=max_new, **how))
             for p in prompts] if srv.primary else list(range(len(prompts))))
    res = srv.run_until_drained()
    return srv, [res[r].tokens for r in rids]


# the sampled server's requests: top-p and seed
SRV_SAMPLE = (0.9, 5)


IDLE_PROMPT = server_prompts(14, (7,))[0]


REPL_LINES = ["hello there\n", "how are you\n"]


class SlowLines:
    """Input lines that each come after ``wait`` seconds (a REPL's user)."""

    def __init__(self, lines, wait: float):
        self.lines, self.wait = lines, wait

    def __iter__(self):
        import time

        for line in self.lines:
            time.sleep(self.wait)
            yield line


def repl_model():
    """The REPL's tokenizer, special tokens, config and weights."""
    tok, st = session_tokenizer()
    cfg = ModelConfig(**{**RUN, "vocab_size": st.vocab_size, "use_cross_attention": False})
    return tok, st, cfg, init(cfg, seed=6)


def idle_mesh_ranks(rank: int, idle_s: float, timeout_s: float) -> dict:
    """Rank 0 of a model=2 mesh waits ``idle_s`` at a time, longer than the
    world's collective timeout ``timeout_s``: the REPL for each of its
    lines, then the HTTP front end for its one greedy request. Rank 0
    returns the REPL's output and the reply; rank 1 follows both."""
    import datetime
    import io
    import json
    import time
    import urllib.request

    from torch.distributed.distributed_c10d import _set_pg_timeout

    from ergm_tpu_torch.infer.http_server import ServerFrontend
    from ergm_tpu_torch.infer.interact import run_repl
    from ergm_tpu_torch.infer.server import ContinuousServer

    dist.barrier()  # both ranks are up: the short timeout holds from here
    _set_pg_timeout(datetime.timedelta(seconds=timeout_s))
    mesh = make_mesh((1, 2), ("data", "model"))
    tok, st, rcfg, rp = repl_model()
    out = io.StringIO()
    run_repl(shard_params(rp, mesh), rcfg, st, tok, max_len=64, top_p=0.9, seed=1, mesh=mesh,
             stdin=SlowLines(REPL_LINES, idle_s), stdout=out)

    cfg = ModelConfig(**SRV)
    srv = ContinuousServer(shard_params(init(cfg), mesh), cfg, slots=2, mesh=mesh, sync_every=4,
                           **SRV_KW)
    if not srv.primary:
        t0 = time.monotonic()
        srv.follow()
        return {"followed_s": time.monotonic() - t0}
    fe = ServerFrontend(srv, port=0).start()
    try:
        time.sleep(idle_s)
        body = json.dumps({"prompt": IDLE_PROMPT, "max_new_tokens": 8, "greedy": True})
        req = urllib.request.Request(f"http://{fe.host}:{fe.port}/generate", data=body.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return {"repl": out.getvalue(), "http": json.loads(r.read())}
    finally:
        fe.close()


def session_tokenizer():
    """A small BPE with the special tokens registered (the REPL's)."""
    from ergm_tpu_torch.core.tokens import SpecialTokens
    from ergm_tpu_torch.tokenizer.bpe import train_bpe

    tok = train_bpe(["hello there how are you doing today my friend"] * 3, vocab_size=300)
    vocab = dict(tok.vocab)
    st = SpecialTokens.register(vocab)
    tok.add_special_tokens([t for t in vocab if t not in tok.vocab])
    return tok, st


def counting(module, name: str, counts: dict):
    """Wraps ``module.name`` to count its calls into ``counts[name]``."""
    real = getattr(module, name)

    def run(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return real(*args, **kwargs)
    setattr(module, name, run)


def mesh_infer_ranks(rank: int, data_dir: str) -> dict:
    """Every inference entry point over a data=2 x model=2 mesh (and a
    data-only mesh of 4 for the server's slot axis), on weights each rank
    makes from the same seeds (``init``)."""
    import os

    from ergm_tpu_torch.data.assembly import read_meta
    from ergm_tpu_torch.data.dataset import DialogueDataset
    from ergm_tpu_torch.infer.beam import beam_search_batch
    from ergm_tpu_torch.infer.generate import generate_batch
    from ergm_tpu_torch.infer.interact import DialogueSession
    from ergm_tpu_torch.infer.runner import run_test
    from ergm_tpu_torch.infer.server import ContinuousServer
    from ergm_tpu_torch.ops import cross_decode, fused_decode
    from ergm_tpu_torch.parallel.dryrun import dryrun_multichip

    out = {}
    mesh = make_mesh((2, 2), ("data", "model"))
    out["coords"] = (mesh.index("data"), mesh.index("model"))

    cfg = ModelConfig(**GEN)
    params = shard_params(gpt2.params_for_inference(init(cfg), cfg), mesh)
    out["heads"] = params.blocks[0].attn.c_attn.kernel.shape[1] // (3 * cfg.head_dim)
    prompts, kw = gen_inputs(5)
    out["greedy"] = generate_batch(params, cfg, prompts, greedy=True, mesh=mesh, **kw, **GEN_KW)
    out["sampled"] = generate_batch(params, cfg, prompts, top_p=0.9, mesh=mesh,
                                    generator=torch.Generator().manual_seed(3), **kw, **GEN_KW)
    # K3's and K4's tensor-parallel forms (their plain versions here)
    counts = {}
    counting(cross_decode, "fused_cross_decode_partial_reference", counts)
    counting(fused_decode, "fused_ln_mlp_partial_reference", counts)
    os.environ["ERGM_CROSS_KERNEL"] = "1"
    try:
        prompts8, kw8 = gen_inputs(8)
        kcfg = cfg.replace(decode_fused_mlp=True)
        out["kernels"] = generate_batch(params, kcfg, prompts8, greedy=True, mesh=mesh, **kw8,
                                        **GEN_KW)
    finally:
        del os.environ["ERGM_CROSS_KERNEL"]
    out["tp_forms"] = counts
    del params

    bcfg = ModelConfig(**BEAM)
    out["beam"] = beam_search_batch(shard_params(init(bcfg, seed=3), mesh), bcfg, BEAM_PROMPTS,
                                    mesh=mesh, **BEAM_KW)

    st = read_meta(data_dir)
    rcfg = ModelConfig(**RUN, vocab_size=st.vocab_size)
    rp = shard_params(init(rcfg, seed=4), mesh)
    ds = DialogueDataset("valid", data_dir, sp1_id=st.sp1_id, sp2_id=st.sp2_id,
                         eos_id=st.eos_id, max_len=128)
    rkw = dict(batch_size=4, eos_id=st.eos_id, sp2_id=st.sp2_id, max_len=128, top_p=0.8,
               seed=2, max_new_tokens=8, mesh=mesh)
    out["run_test"] = tuple(run_test(rp, rcfg, ds, **rkw))
    out["run_test_beam"] = tuple(run_test(rp, rcfg, ds, num_beams=2, **rkw))

    tok, tst = session_tokenizer()
    scfg = ModelConfig(**{**RUN, "vocab_size": tst.vocab_size, "use_cross_attention": False})
    session = DialogueSession(shard_params(init(scfg, seed=6), mesh), scfg, tst, tok,
                              max_len=64, top_p=0.9, seed=1, mesh=mesh)
    out["session"] = [session.reply(t, max_new_tokens=8) for t in ("hello there", "how are you")]

    srv_cfg = ModelConfig(**SRV)
    sp = shard_params(init(srv_cfg), mesh)
    srv, out["server"] = serve_greedy(sp, srv_cfg, server_prompts(8, (6, 13, 9)), mesh, 2)
    out["server_state"] = (tuple(srv.caches[0].k.shape), tuple(srv.emo_slot.shape))
    _, out["server_sampled"] = serve_greedy(sp, srv_cfg, server_prompts(8, (6, 13, 9)), mesh, 2,
                                            sample=SRV_SAMPLE)
    _, out["spec"] = serve_greedy(sp, srv_cfg, SPEC_PROMPTS, mesh, 4, sync_every=3,
                                  spec_gamma=3, spec_ngram=2)
    out["features"] = {k: serve_greedy(sp, srv_cfg, FEATURE_PROMPTS, mesh, 4, **kw_)[1]
                       for k, kw_ in SRV_FEATURES.items()}
    dp4 = make_mesh((4,), ("data",))
    srv, out["server_dp4"] = serve_greedy(init(srv_cfg), srv_cfg,
                                          server_prompts(9, (6, 13, 9, 17, 5)), dp4, 4)
    out["server_dp4_state"] = (tuple(srv.caches[0].k.shape), tuple(srv.emo_slot.shape))
    errors = []
    for kw_ in (dict(slots=6), dict(slots=8, long_slots=2)):
        try:
            ContinuousServer(init(srv_cfg), srv_cfg, mesh=dp4, **SRV_KW, **kw_)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["server_errors"] = errors
    del sp, srv

    xl = ModelConfig.from_model_type("gpt2-xl", **XL_KW)
    xp = shard_params(init(xl, seed=5), mesh)
    out["xl_heads"] = xp.blocks[0].attn.c_attn.kernel.shape[1] // (3 * xl.head_dim)
    out["xl"] = generate_batch(xp, xl, XL_PROMPTS, greedy=True, mesh=mesh, max_len=32, eos_id=7,
                               sp2_id=5, prompt_bucket=8, max_new_tokens=4)
    del xp
    out["dryrun"] = dryrun_multichip(4, "cpu")
    return out
