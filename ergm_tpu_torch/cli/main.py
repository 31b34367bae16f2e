"""CLI of the PyTorch port (counterpart of ``ergm_tpu/cli/main.py``):
every flag of the reference-compatible surface, with the same names and
defaults, so ``train_torch.sh`` / ``infer_torch.sh`` make the calls
``train.sh`` / ``infer.sh`` make.

``--mode=train`` runs the Trainer; ``--mode=infer`` needs a checkpoint,
runs the batched KV-cached test pass, evaluates (dist-1/2, BERTScore
with a local scorer model, PPL, emotion accuracy), prints, and writes
``{ckpt_name}_evaluation_results.txt`` and ``{ckpt_name}_generations.txt``
into the data dir; ``--mode=serve`` runs the continuous-batching server
over a JSONL requests file or an HTTP endpoint (``--serve_http``);
``--mode=interact`` a dialogue REPL.

``--gpu`` picks the device of one process: a CUDA index (default 0) or
``cpu``. A card that is not there fails the run.

``--mode=train`` trains over the mesh of ``--mesh_shape`` /
``--mesh_axes`` with one process per device (``parallel/distributed.py``):
- the default ``-1`` on a host with N cards starts N processes itself
  (data parallelism over N; one card: one process, as before); an
  explicit shape starts as many as it has ranks (``--gpu=cpu``: CPU
  processes over gloo);
- ``ERGM_COORDINATOR`` / ``ERGM_NUM_PROCESSES`` / ``ERGM_PROCESS_ID``
  (JAX's launcher contract, one process per host) make each host start
  its local processes and join them to one world;
- under an external launcher (``WORLD_SIZE`` set, e.g. torchrun) the
  process joins that world instead, on ``cuda:<LOCAL_RANK>``.
``--shard_opt_state`` is ZeRO-1 over the data axis.

``--mode=infer|serve|interact`` serve over the mesh of ``--mesh_shape``
(JAX's ``_serving_mesh``) in the same worlds: the default ``-1`` shrinks
the data axis to the largest divisor of ``--batch_size`` (and of both
serving pools) that the local cards allow, and the REPL takes a mesh only
from an explicit shape; a mesh of one device is none. An explicit shape
whose data axis does not divide the batch is refused. Each rank loads the
checkpoint and keeps its shard of the parameters; rank 0 alone prints,
writes the generations and results, reads the REPL's input and serves
HTTP, the other ranks following it (``infer/server.py``). ZeRO-1 has no
meaning at inference and is ignored there, as in JAX.
JAX's persistent compilation cache has no counterpart: the port builds
its kernels once into ``ergm_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ergm_tpu_torch.core.config import ModelConfig, TrainConfig
from ergm_tpu_torch.core.device import resolve

_LAUNCHER = ("ERGM_COORDINATOR", "ERGM_NUM_PROCESSES", "ERGM_PROCESS_ID")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ERGM train/infer CLI on PyTorch + CUDA")
    # reference flags (src/main.py:339-361), names and defaults preserved
    p.add_argument("--seed", type=int, default=0, help="The random seed.")
    p.add_argument("--mode", type=str, required=True,
                   choices=["train", "infer", "interact", "serve"],
                   help="train/infer match the reference surface; interact "
                        "adds a live dialogue REPL on a trained checkpoint; "
                        "serve runs the continuous-batching server over a "
                        "JSONL requests file (infer/server.py).")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--train_prefix", type=str, default="train")
    p.add_argument("--valid_prefix", type=str, default="valid")
    p.add_argument("--model_type", type=str, default="gpt2")
    p.add_argument("--bos_token", type=str, default="<bos>")
    p.add_argument("--sp1_token", type=str, default="<sp1>")
    p.add_argument("--sp2_token", type=str, default="<sp2>")
    p.add_argument("--gpu", type=str, default="0",
                   help="CUDA device index (the reference's meaning), or 'cpu'. "
                        "Without a card an index fails; it never falls back "
                        "to the CPU.")
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--max_turns", type=int, default=10)
    p.add_argument("--top_p", type=float, default=0.95)
    p.add_argument("--ckpt_dir", type=str, default="saved_models")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--ckpt_name", type=str, default=None)
    # the reference's train.sh passes --layers=0 against an argparse that
    # lacks the flag and dies (SURVEY.md §2.4.7); accept and ignore it
    p.add_argument("--layers", type=int, default=None, help=argparse.SUPPRESS)
    # ergm_tpu's additions
    p.add_argument("--mesh_shape", type=str, default="-1",
                   help="Comma-separated mesh shape over the world's ranks (one "
                        "process per device); -1 = every local card, data "
                        "parallel (at inference: the largest data axis that "
                        "divides the batch).")
    p.add_argument("--mesh_axes", type=str, default="data",
                   help="Comma-separated axis names matching --mesh_shape.")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", dest="remat", action="store_true", default=True,
                   help="Per-block rematerialization (default on: it unlocks "
                        "larger batches).")
    p.add_argument("--no_remat", dest="remat", action="store_false")
    p.add_argument("--remat_policy", type=str, default=None,
                   choices=["full", "dots", "mlp", "mlp_only"],
                   help="Rematerialization policy (default mlp). ergm_tpu's "
                        "single-chip recipes, measured on a TPU: gpt2 B=48 mlp; "
                        "gpt2-medium B=12 mlp + --adam_mu_dtype=bfloat16; "
                        "gpt2-large B=12 full + --adam_mu_dtype=bfloat16.")
    p.add_argument("--tokenizer_dir", type=str, default=None,
                   help="Dir with GPT-2 vocab.json/merges.txt for text decode.")
    p.add_argument("--init_params", type=str, default=None,
                   help="Params file or checkpoint dir to initialize from "
                        "(see ergm_tpu_torch.cli.convert_ckpt; an ergm_tpu "
                        "orbax checkpoint goes through ergm_tpu.cli."
                        "convert_ckpt --reverse, then that tool).")
    p.add_argument("--prompt_mode", type=str, default="reference",
                   choices=["reference", "history"],
                   help="Infer prompts: 'reference' replicates src/main.py:316 "
                        "(full non-eos prefix); 'history' prompts with the "
                        "masked-history prefix only.")
    p.add_argument("--bert_model_dir", type=str, default=None,
                   help="Local HF encoder dir for BERTScore (no downloads).")
    p.add_argument("--bert_layer", type=int, default=None,
                   help="Hidden layer for BERTScore embeddings. Default: "
                        "the official scorer's per-model layer when the "
                        "model is recognized (e.g. 17 for roberta-large), "
                        "else the last layer.")
    p.add_argument("--bert_idf", action="store_true",
                   help="idf-weight BERTScore tokens (computed over the "
                        "reference corpus, like the official scorer).")
    p.add_argument("--bert_baselines", type=str, default=None,
                   help="BERTScore rescaling baselines: either a path to "
                        "an official bert_score rescale-baseline csv "
                        "(LAYER,P,R,F1 rows; the layer row in use is "
                        "selected automatically) or comma-separated P,R,F1 "
                        "numbers, e.g. '0.83,0.83,0.83'.")
    p.add_argument("--require_bertscore", action="store_true",
                   help="Fail the run if BERTScore cannot be computed "
                        "instead of skipping the metric.")
    p.add_argument("--num_beams", type=int, default=1,
                   help=">1 decodes with beam search instead of nucleus "
                        "sampling during inference.")
    p.add_argument("--sampler", type=str, default="full_sort",
                   choices=["approx", "exact", "full_sort"],
                   help="Nucleus sampler. Default 'full_sort' "
                        "(reference-identical full-vocab top-p) — measured "
                        "necessary for faithful quality metrics whenever "
                        "the nucleus exceeds 64 tokens "
                        "(results/sampler_quality.jsonl). 'approx' "
                        "(approx_max_k top-64, a TPU option) is not ported "
                        "and raises; 'exact' is the exact top-64.")
    p.add_argument("--kv_cache", type=str, default="auto",
                   choices=["auto", "int8"],
                   help="Decode KV-cache storage; int8 trades ~1e-2-level "
                        "sampling drift for decode throughput.")
    p.add_argument("--weight_dtype", type=str, default="auto",
                   choices=["auto", "int8"],
                   help="Serving weight storage; int8 (weight-only, "
                        "per-out-channel scales) halves weight-read HBM "
                        "traffic — the small-batch decode bottleneck.")
    p.add_argument("--keep_best", type=int, default=None,
                   help="Retain only the N lowest-PPL checkpoints "
                        "(default: keep all, like the reference).")
    p.add_argument("--limit", type=int, default=None,
                   help="Debug: use only the first N dialogues "
                        "(the reference's [:1] slice, made explicit).")
    p.add_argument("--draft_layers", type=int, default=0,
                   help="B=1 serving: >0 enables self-speculative decoding "
                        "with a draft built from the first N transformer "
                        "blocks (greedy output identical; sampling exact "
                        "via rejection sampling).")
    p.add_argument("--spec_gamma", type=int, default=4,
                   help="Speculative proposals per macro step.")
    p.add_argument("--spec_mode", type=str, default="auto",
                   choices=["auto", "none", "draft", "ngram"],
                   help="Speculative draft source: 'draft' = first "
                        "--draft_layers blocks of the model; 'ngram' = "
                        "prompt-lookup (propose the continuation of the "
                        "last n-gram's most recent earlier occurrence — "
                        "zero draft compute, wins whenever dialogue "
                        "repeats its context). Both are exact. 'auto' "
                        "(default) applies ergm_tpu's policy, measured on "
                        "a TPU: greedy B=1 -> ngram on; sampled -> off "
                        "(B1_LATENCY.json, results/spec_bench.jsonl).")
    p.add_argument("--spec_ngram", type=int, default=3,
                   help="Lookup n-gram length for --spec_mode=ngram.")
    p.add_argument("--requests_file", type=str, default=None,
                   help="serve mode: JSONL requests — {'prompt': [ids...]} "
                        "or {'text': '...'} (text needs --tokenizer_dir); "
                        "optional max_new_tokens/top_p/temperature/"
                        "greedy/seed/stop/logprobs/"
                        "caption_ids/arrival_s/session_id/pool per line "
                        "(session_id: multi-turn continuation — the next "
                        "turn's full prompt prefills only its new tokens "
                        "against the session's retained KV).")
    p.add_argument("--serve_http", type=int, default=None, metavar="PORT",
                   help="serve mode: run an online HTTP endpoint on "
                        "localhost:PORT instead of a batch requests file "
                        "(POST /generate with prompt|text + stream flag, "
                        "GET /health; infer/http_server.py).")
    p.add_argument("--serve_output", type=str, default=None,
                   help="serve mode: output JSONL (default "
                        "<requests_file>.responses.jsonl).")
    p.add_argument("--serve_sync", type=int, default=8,
                   help="serve mode: decode steps per host sync block.")
    p.add_argument("--serve_spec_gamma", type=int, default=0,
                   help="serve mode: speculative serving — draft this many "
                        "tokens per macro step via device prompt-lookup "
                        "(n-gram) and verify them in one forward; per-slot "
                        "cursors advance by the accepted prefix + 1. Exact "
                        "greedy output; blocks with sampled rows fall back "
                        "to plain decode. 0 disables.")
    p.add_argument("--serve_spec_ngram", type=int, default=3,
                   help="serve mode: lookup n-gram length for "
                        "--serve_spec_gamma.")
    p.add_argument("--serve_prefill_chunk", type=int, default=0,
                   help="serve mode: admit prompts in chunks of this many "
                        "tokens (one chunk per decode block), bounding the "
                        "decode-latency hiccup a long prompt's admission "
                        "injects into concurrent streams; also lifts the "
                        "max-prompt admission cap (only chunks ever "
                        "prefill). 0 disables (single-shot admission).")
    p.add_argument("--serve_long_slots", type=int, default=0,
                   help="serve mode: length-tiered slot pools — reserve "
                        "this many slots as a LONG pool with its own KV "
                        "cache and capacity rung, so one long request no "
                        "longer widens the cache every short slot reads "
                        "(requests route by prompt + max_new_tokens - 1 "
                        "— the final KV cursor — vs "
                        "--serve_long_threshold, or per-request "
                        "'pool': 'long'|'short'). 0 disables.")
    p.add_argument("--serve_long_threshold", type=int, default=None,
                   help="serve mode: expected final length above which a "
                        "request routes to the long pool. Default: with "
                        "--requests_file, the (1 - K/S) quantile of the "
                        "file's expected final lengths (max_prompt — the "
                        "library default — is the LONGEST prompt's bucket "
                        "there, which would route everything short); with "
                        "--serve_http, max_prompt, with a warning.")
    p.add_argument("--serve_admit_policy", type=str, default=None,
                   choices=["fifo", "sorted"],
                   help="serve mode admission order: fifo (latency-fair) "
                        "or sorted (length-sorted cohorts -- co-resident "
                        "rows finish together). Default: sorted for batch "
                        "--requests_file runs (ergm_tpu's choice, measured "
                        "on a TPU: matrix2_summary_r5), fifo for "
                        "--serve_http (sorted starves under live "
                        "arrivals).")
    p.add_argument("--serve_pipeline", action="store_true",
                   help="serve mode: throughput mode — dispatch each decode "
                        "block before harvesting the previous one, hiding "
                        "the per-block host round trip behind device "
                        "compute (costs one block of finish-detection lag; "
                        "default synchronous order is the latency mode).")
    p.add_argument("--attn_pdrop", type=float, default=None,
                   help="Attention-probability dropout (default 0.1, the "
                        "reference's regularization; runs in-kernel on the "
                        "fused block-attention path — see PARITY.md).")
    p.add_argument("--resid_pdrop", type=float, default=None,
                   help="Residual dropout override (default 0.1).")
    p.add_argument("--embd_pdrop", type=float, default=None,
                   help="Embedding dropout override (default 0.1).")
    p.add_argument("--adam_mu_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"],
                   help="Adam first-moment storage dtype; bfloat16 halves "
                        "the momentum buffer (HBM headroom for larger "
                        "batches under remat).")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="Average gradients over k micro-batches per "
                        "optimizer update (effective batch k*batch_size "
                        "past the single-chip HBM frontier).")
    p.add_argument("--length_grouped", type=int, default=0,
                   help="K > 1: sort examples by length within megabatches "
                        "of K*batch_size (batch order reshuffled) so "
                        "similar-length rows share a bucket (less pad "
                        "compute on real dialogue data). 0 = reference-like "
                        "uniform shuffle.")
    p.add_argument("--pad_multiple", type=int, default=128,
                   help="Bucket quantum for batch sequence lengths; 64 with "
                        "--length_grouped recovers more pad waste at the "
                        "cost of up to 2x compiled shapes.")
    p.add_argument("--shard_opt_state", action="store_true",
                   help="ZeRO-1: shard AdamW's fp32 moments over the mesh "
                        "data axis instead of replicating them per chip "
                        "(the memory that gates gpt2-xl under pure data "
                        "parallelism). Training only.")
    p.add_argument("--save_on_preempt", type=int, default=1, choices=[0, 1],
                   help="1 (default): on SIGTERM (spot/preemptible VM "
                        "preemption) save an emergency checkpoint at the "
                        "next step-block boundary and exit; resume with "
                        "--ckpt_name=preempt. A second SIGTERM exits "
                        "immediately.")
    return p


def args_to_config(args) -> TrainConfig:
    mesh_shape = tuple(int(x) for x in str(args.mesh_shape).split(","))
    mesh_axes = tuple(str(args.mesh_axes).split(","))
    return TrainConfig(
        seed=args.seed, mode=args.mode, data_dir=args.data_dir,
        train_prefix=args.train_prefix, valid_prefix=args.valid_prefix,
        model_type=args.model_type, bos_token=args.bos_token,
        sp1_token=args.sp1_token, sp2_token=args.sp2_token,
        lr=args.lr, warmup_ratio=args.warmup_ratio, batch_size=args.batch_size,
        num_workers=args.num_workers, num_epochs=args.num_epochs,
        max_len=args.max_len, max_turns=args.max_turns, top_p=args.top_p,
        ckpt_dir=args.ckpt_dir, output_dir=args.output_dir,
        ckpt_name=args.ckpt_name, mesh_shape=mesh_shape,
        mesh_axis_names=mesh_axes, dtype=args.dtype, remat=args.remat,
        tokenizer_dir=args.tokenizer_dir, init_params=args.init_params,
        keep_best=args.keep_best,
        attn_pdrop=args.attn_pdrop, resid_pdrop=args.resid_pdrop,
        embd_pdrop=args.embd_pdrop, adam_mu_dtype=args.adam_mu_dtype,
        remat_policy=args.remat_policy,
        grad_accum_steps=args.grad_accum_steps,
        length_grouped=args.length_grouped, pad_multiple=args.pad_multiple,
        save_on_preempt=bool(args.save_on_preempt),
        shard_opt_state=args.shard_opt_state,
    )




def device_of(args) -> torch.device:
    """``--gpu``: a CUDA index, or ``cpu``."""
    gpu = str(args.gpu).strip()
    return resolve("cpu" if gpu == "cpu" else f"cuda:{int(gpu)}")


def _serving_batch(cfg: TrainConfig, args) -> tuple:
    """(batch, long slots) that a serving mesh's data axis must divide:
    none for the REPL (one row)."""
    if cfg.mode == "interact":
        return 0, 0
    return cfg.batch_size, (args.serve_long_slots if cfg.mode == "serve" else 0)


def _serving_shape(cfg: TrainConfig, devices: int, batch_size: int = 0,
                   long_slots: int = 0) -> Optional[tuple]:
    """JAX's ``_serving_mesh`` rule (``ergm_tpu/cli/main.py:305-345``) over
    ``devices`` ranks: the mesh shape, or None for a single device. The
    default -1 shrinks the data axis to the largest divisor of the batch
    (and of both pools with ``long_slots``) instead of failing, and takes
    no mesh without a batch (the REPL); an explicit shape is strict."""
    shape, axes = [int(x) for x in cfg.mesh_shape], tuple(cfg.mesh_axis_names)
    if tuple(shape) == (-1,):
        if not batch_size:
            return None
        dp = devices
        while dp > 1 and (batch_size % dp or (long_slots and (
                (batch_size - long_slots) % dp or long_slots % dp))):
            dp -= 1
        shape = [dp] + [1] * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if devices % known:
            raise ValueError(f"{devices} devices not divisible by {known}")
        shape[shape.index(-1)] = devices // known
    if int(np.prod(shape)) <= 1:
        return None
    dp = shape[axes.index("data")] if "data" in axes else 1
    if batch_size and batch_size % dp:
        raise ValueError(f"batch_size={batch_size} must be divisible by the mesh data axis "
                         f"({dp} devices); pick a divisible batch size or a smaller "
                         f"--mesh_shape")
    return tuple(shape)


def _place_params(params, mesh):
    """This rank's shard of the serving parameters (JAX's ``_place_params``):
    the model axis's part of each tensor; whole without one."""
    from ergm_tpu_torch.core.mesh import shard_params

    return params if mesh is None else shard_params(params, mesh)


def run_inference(cfg: TrainConfig, args, argv: list, run) -> None:
    """--mode=infer|serve|interact: ``run(cfg, args, mesh, device)`` in one
    process, or in each of a world's (the module docstring): this host's
    processes are started as --mode=train starts them, or join a
    launcher's world."""
    from ergm_tpu_torch.parallel import distributed

    cpu = str(args.gpu).strip() == "cpu"
    env = os.environ
    batch, long_slots = _serving_batch(cfg, args)
    if env.get("WORLD_SIZE") is None:
        hosts = int(env["ERGM_NUM_PROCESSES"]) if env.get("ERGM_NUM_PROCESSES") else 1
        launcher = any(env.get(k) for k in _LAUNCHER)
        if launcher and not all(env.get(k) for k in _LAUNCHER):
            distributed.initialize_from_env()  # raises JAX's partial-environment error
        explicit = tuple(cfg.mesh_shape) != (-1,)
        devices = hosts * (1 if cpu else torch.cuda.device_count())
        if explicit and -1 not in cfg.mesh_shape:
            devices = int(np.prod(cfg.mesh_shape))
        shape = _serving_shape(cfg, devices, batch, long_slots)
        n = 1 if shape is None else -(-int(np.prod(shape)) // hosts)
        if n > 1 and not cpu and n > torch.cuda.device_count():
            raise ValueError(f"mesh shape {list(shape)} needs {int(np.prod(shape))} devices, "
                             f"have {torch.cuda.device_count() * hosts}")
        if n > 1 or launcher:
            _spawn(argv, n, hosts, int(env.get("ERGM_PROCESS_ID", "0")),
                   env.get("ERGM_COORDINATOR"), stdin=cfg.mode == "interact")
            return
        run(cfg, args, None, device_of(args))
        return
    from ergm_tpu_torch.core.mesh import make_mesh

    device = torch.device("cpu") if cpu else distributed.local_device("cuda")
    info = distributed.initialize_from_env(device=device)
    try:
        shape = _serving_shape(cfg, info["global_devices"], batch, long_slots)
        mesh = None if shape is None else make_mesh(shape, cfg.mesh_axis_names)
        with contextlib.ExitStack() as stack:
            if distributed.is_primary():
                print(f"world: {info['global_devices']} ranks over {info['process_count']} "
                      f"host(s), {info['local_devices']} a host, backend {info['backend']}")
                if mesh is not None:
                    print(f"Serving over mesh {mesh.shape}")
            else:  # rank 0 alone prints
                stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
            run(cfg, args, mesh, device)
    finally:
        distributed.shutdown()


def _local_processes(cfg: TrainConfig, args, hosts: int) -> int:
    """How many training processes this host runs: every card under the
    default -1 (one on the CPU), else this host's share of the mesh's
    ranks."""
    shape = [int(x) for x in cfg.mesh_shape]
    cpu = str(args.gpu).strip() == "cpu"
    cards = 1 if cpu else torch.cuda.device_count()
    if -1 in shape:
        return cards
    total = int(np.prod(shape))
    n = -(-total // hosts)
    if not cpu and n > max(cards, 1):  # one process takes --gpu's card, or fails there
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {cards * hosts}")
    return n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _PipeLines:
    """The lines the parent forwards over a pipe (None ends them): a
    spawned process's stdin is /dev/null, so the REPL's rank 0 reads the
    parent's this way."""

    def __init__(self, conn):
        self.conn = conn

    def __iter__(self):
        while True:
            line = self.conn.recv()
            if line is None:
                return
            yield line


def _child(argv: list, env: dict, stdin=None) -> None:
    """A spawned process: the launcher environment, then ``main``."""
    os.environ.update(env)
    if stdin is not None:
        sys.stdin = _PipeLines(stdin)
    main(argv)


def _forward_stdin(conn) -> None:
    for line in sys.stdin:
        conn.send(line)
    conn.send(None)


def _spawn(argv: list, n: int, hosts: int, host: int, coordinator: Optional[str],
           stdin: bool = False) -> None:
    """Starts this host's ``n`` processes (torchrun's environment:
    ranks ``host * n`` on, ``LOCAL_RANK`` 0..n-1; multiprocessing's spawn
    method, so each imports this program's main module anew) and waits
    for them; the first to fail stops the others and fails the run.
    ``stdin``: this process's input lines go on to rank 0 (the REPL)."""
    import multiprocessing
    import threading

    addr, port = (coordinator.rsplit(":", 1) if coordinator
                  else ("127.0.0.1", str(_free_port())))
    for k in _LAUNCHER:  # the children join by torchrun's variables
        os.environ.pop(k, None)
    ctx = multiprocessing.get_context("spawn")
    lines = ctx.Pipe(duplex=False) if stdin and host == 0 else None
    procs = []
    for lr in range(n):
        env = dict(WORLD_SIZE=str(hosts * n), RANK=str(host * n + lr), LOCAL_RANK=str(lr),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR=addr, MASTER_PORT=port)
        conn = lines[0] if lines is not None and lr == 0 else None
        p = ctx.Process(target=_child, args=(argv, env, conn), name=f"ergm-rank-{lr}")
        p.start()
        procs.append(p)
    if lines is not None:
        threading.Thread(target=_forward_stdin, args=(lines[1],), daemon=True).start()
    failed = 0
    try:
        while procs and not failed:
            for p in list(procs):
                if p.exitcode is not None:
                    procs.remove(p)
                    failed = failed or p.exitcode
            time.sleep(0.05)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(30)
            if p.exitcode is None:
                p.kill()
                p.join()
    if failed:
        raise SystemExit(f"a process of the world exited with code {failed}")


def run_train(cfg: TrainConfig, args, argv: list) -> None:
    """--mode=train: one process, or this host's processes of a world
    (see the module docstring)."""
    from ergm_tpu_torch.parallel import distributed
    from ergm_tpu_torch.train.trainer import Trainer

    cpu = str(args.gpu).strip() == "cpu"
    env = os.environ
    if env.get("WORLD_SIZE") is None:
        hosts = int(env["ERGM_NUM_PROCESSES"]) if env.get("ERGM_NUM_PROCESSES") else 1
        launcher = any(env.get(k) for k in _LAUNCHER)
        if launcher and not all(env.get(k) for k in _LAUNCHER):
            distributed.initialize_from_env()  # raises JAX's partial-environment error
        n = _local_processes(cfg, args, hosts)
        if n > 1 or launcher:
            _spawn(argv, n, hosts, int(env.get("ERGM_PROCESS_ID", "0")),
                   env.get("ERGM_COORDINATOR"))
            return
        Trainer(cfg, limit=args.limit, device=device_of(args)).train()
        return
    device = torch.device("cpu") if cpu else distributed.local_device("cuda")
    info = distributed.initialize_from_env(device=device)
    try:
        if distributed.is_primary():
            print(f"world: {info['global_devices']} ranks over {info['process_count']} "
                  f"host(s), {info['local_devices']} a host, backend {info['backend']}")
        Trainer(cfg, limit=args.limit, device=device).train()
    finally:
        distributed.shutdown()


def _load_tokenizer(tokenizer_dir: str, st):
    """The decode tokenizer with the special-token registry attached,
    checked against the vocab recorded at data-build time."""
    from ergm_tpu_torch.tokenizer.bpe import load_or_train_default

    tok = load_or_train_default(tokenizer_dir)
    if len(tok) != st.vocab_size:
        warnings.warn(
            f"tokenizer vocab ({len(tok)}) != tokenizer_meta.json vocab "
            f"({st.vocab_size}); decoded text may be wrong — rebuild the "
            f"data or pass the tokenizer dir used at load_data time")
    return tok


def _serving_params(cfg: TrainConfig, mcfg: ModelConfig, device, seed: int,
                    required: bool):
    """Random init from ``seed`` with the checkpoint ``cfg.ckpt_name`` loaded
    over it, ready for inference. A missing checkpoint exits when
    ``required``, else warns (replies then come from the random init)."""
    from ergm_tpu_torch.models import gpt2
    from ergm_tpu_torch.train import checkpoint as ckpt_lib

    params = gpt2.init_params(torch.Generator().manual_seed(seed), mcfg, device=device)
    path = ckpt_lib.find_checkpoint(cfg.ckpt_dir, cfg.ckpt_name) if cfg.ckpt_name else None
    if path:
        print(f"Loading checkpoint {path}")
        params = ckpt_lib.restore_params(path, params)
    elif required:
        print(f"Cannot find checkpoint {cfg.ckpt_name!r} under {cfg.ckpt_dir}")
        sys.exit(1)
    else:
        print("WARNING: no checkpoint found; responses come from random init")
    return gpt2.params_for_inference(params, mcfg)


def run_infer(cfg: TrainConfig, args, mesh=None, device=None) -> dict:
    """--mode=infer on ``device`` (``--gpu``'s by default), over ``mesh``
    when one is given: every rank decodes, rank 0 evaluates and writes."""
    from ergm_tpu_torch.data.assembly import read_meta
    from ergm_tpu_torch.data.dataset import DialogueDataset
    from ergm_tpu_torch.evaluation.evaluate import Evaluator
    from ergm_tpu_torch.infer.runner import run_test, write_generations
    from ergm_tpu_torch.parallel.distributed import is_primary

    device = device_of(args) if device is None else device
    st = read_meta(cfg.data_dir)
    mcfg = ModelConfig.from_model_type(cfg.model_type, vocab_size=st.vocab_size,
                                       dtype=cfg.dtype, kv_cache_dtype=args.kv_cache,
                                       weight_dtype=args.weight_dtype)
    max_len = min(cfg.max_len, mcfg.n_positions)
    dataset = DialogueDataset(cfg.valid_prefix, cfg.data_dir, sp1_id=st.sp1_id,
                              sp2_id=st.sp2_id, eos_id=st.eos_id,
                              max_len=max_len, limit=args.limit)
    params = _place_params(_serving_params(cfg, mcfg, device, seed=0, required=True), mesh)
    tokenizer = _load_tokenizer(cfg.tokenizer_dir, st) if cfg.tokenizer_dir else None

    res = run_test(
        params, mcfg, dataset, batch_size=cfg.batch_size, eos_id=st.eos_id,
        sp2_id=st.sp2_id, max_len=max_len, top_p=cfg.top_p, seed=cfg.seed,
        tokenizer=tokenizer, prompt_mode=args.prompt_mode, num_beams=args.num_beams,
        sampler=args.sampler, draft_layers=args.draft_layers, spec_gamma=args.spec_gamma,
        spec_mode=args.spec_mode, spec_ngram=args.spec_ngram, mesh=mesh)
    if not is_primary():
        return {}

    gen_path = os.path.join(cfg.data_dir, f"{cfg.ckpt_name}_generations.txt")
    write_generations(gen_path, res.contexts, res.references, res.hypotheses)
    print(f"Sample generations written to {gen_path}")

    baselines = None
    if args.bert_baselines:
        if os.path.exists(args.bert_baselines):
            baselines = args.bert_baselines  # official baseline csv path
        else:
            p_, r_, f_ = (float(x) for x in args.bert_baselines.split(","))
            baselines = {"precision": p_, "recall": r_, "f1": f_}
    evaluator = Evaluator(bert_model_dir=args.bert_model_dir, bert_layer=args.bert_layer,
                          bert_idf=args.bert_idf, bert_baselines=baselines,
                          require_bertscore=args.require_bertscore, device=device)
    metrics = evaluator.evaluate_all(res.hypotheses, res.references,
                                     true_label_ids=res.true_labels, losses=res.losses,
                                     pred_label_ids=res.pred_labels,
                                     loss_token_counts=res.loss_tokens)

    print("\n--- Final Evaluation Results ---")
    for k, v in metrics.items():
        print(f"{k.upper():<12}: {v:.4f}" if isinstance(v, float) else f"{k.upper():<12}: {v}")
    print("--------------------------------")
    out_path = os.path.join(cfg.data_dir, f"{cfg.ckpt_name}_evaluation_results.txt")
    with open(out_path, "w", encoding="utf-8") as f:
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")
        # the decode configuration, so that published numbers are reproducible
        f.write(f"sampler: {args.sampler}\n")
        f.write(f"num_beams: {args.num_beams}\n")
        f.write(f"top_p: {cfg.top_p}\n")
        f.write(f"kv_cache: {args.kv_cache}\n")
        f.write(f"weight_dtype: {args.weight_dtype}\n")
        if args.draft_layers or args.spec_mode == "ngram":
            f.write(f"spec_mode: {args.spec_mode}\n")
            f.write(f"draft_layers: {args.draft_layers}\n")
            f.write(f"spec_gamma: {args.spec_gamma}\n")
            if args.spec_mode == "ngram":
                f.write(f"spec_ngram: {args.spec_ngram}\n")
    print(f"Results written to {out_path}")
    return metrics


def main(argv: Optional[list] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    # path suffixing with the model type (src/main.py:364-365)
    args.data_dir = os.path.join(args.data_dir, args.model_type)
    args.ckpt_dir = os.path.join(args.ckpt_dir, args.model_type)
    cfg = args_to_config(args)

    if args.mode == "train":
        run_train(cfg, args, argv)
    elif args.mode == "interact":
        run_inference(cfg, args, argv, run_interact)
    elif args.mode == "serve":
        run_inference(cfg, args, argv, run_serve)
    else:
        if cfg.ckpt_name is None:
            raise SystemExit("Please specify the trained checkpoint using --ckpt_name.")
        run_inference(cfg, args, argv, run_infer)


def run_serve(cfg: TrainConfig, args, mesh=None, device=None):
    """--mode=serve: the continuous-batching server (infer/server.py)
    over a JSONL requests file, or an HTTP endpoint with --serve_http.
    Each input line becomes a Request; lines with "arrival_s" are
    admitted on a real-time clock, others queue at once. One JSON line
    per request goes to --serve_output: index, continuation token ids
    (and text with a tokenizer), predicted emotion id, latency; or the
    error of a rejected request. Over ``mesh`` every rank builds the same
    server (the slot axis over the data axis), rank 0 reads the requests
    (or listens) and submits them, and the other ranks follow it."""
    from ergm_tpu_torch.data.assembly import read_meta
    from ergm_tpu_torch.infer.server import ContinuousServer, request_from_json
    from ergm_tpu_torch.parallel.distributed import is_primary

    if not (args.requests_file or args.serve_http is not None):
        raise SystemExit("serve mode needs --requests_file (batch) or --serve_http PORT "
                         "(online)")
    st = read_meta(cfg.data_dir)
    mcfg = ModelConfig.from_model_type(cfg.model_type, vocab_size=st.vocab_size,
                                       dtype=cfg.dtype, weight_dtype=args.weight_dtype,
                                       kv_cache_dtype=args.kv_cache)
    device = device_of(args) if device is None else device
    params = _place_params(_serving_params(cfg, mcfg, device, seed=cfg.seed, required=False),
                           mesh)
    tokenizer = _load_tokenizer(cfg.tokenizer_dir, st) if cfg.tokenizer_dir else None
    primary = mesh is None or is_primary()

    if args.serve_http is not None:  # port 0 = ephemeral, still truthy intent
        from ergm_tpu_torch.infer.http_server import ServerFrontend

        max_prompt = max(
            64, (min(cfg.max_len, mcfg.n_positions - args.serve_sync - 1) // 64) * 64)
        if args.serve_long_slots and args.serve_long_threshold is None:
            print(f"WARNING: --serve_long_slots without "
                  f"--serve_long_threshold defaults the threshold to "
                  f"max_prompt={max_prompt}; requests only route long "
                  f"above that. Set the threshold to your short-traffic "
                  f"ceiling (or send per-request 'pool' hints) so the "
                  f"tier actually separates your workload.")
        srv = ContinuousServer(
            params, mcfg, slots=cfg.batch_size, eos_id=st.eos_id,
            sp2_id=st.sp2_id, max_prompt=max_prompt,
            cache_len=mcfg.n_positions, sync_every=args.serve_sync,
            pipeline=args.serve_pipeline,
            spec_gamma=args.serve_spec_gamma,
            spec_ngram=args.serve_spec_ngram,
            prefill_chunk=args.serve_prefill_chunk,
            long_slots=args.serve_long_slots,
            long_threshold=args.serve_long_threshold,
            admit_policy=args.serve_admit_policy or "fifo", mesh=mesh)
        if not primary:  # rank 0 listens; this rank steps with it until it stops
            srv.follow()
            return
        fe = ServerFrontend(srv, tokenizer=tokenizer, port=args.serve_http,
                            default_top_p=cfg.top_p, default_seed=cfg.seed).start()
        print(f"Serving HTTP on http://{fe.host}:{fe.port} "
              f"(POST /generate, GET /health; Ctrl-C to stop)")
        fe.serve_forever()
        return

    raw = []
    with open(args.requests_file) as f:
        for line in f:
            line = line.strip()
            if line:
                raw.append(json.loads(line))
    reqs = [(request_from_json(r, tokenizer, default_top_p=cfg.top_p,
                               default_seed=cfg.seed),
             float(r.get("arrival_s", 0.0))) for r in raw]

    longest = max((len(q.prompt_ids) for q, _ in reqs), default=64)
    longest = ((longest + 63) // 64) * 64
    max_prompt = longest
    if args.serve_prefill_chunk:
        # chunked admission lifts the prompt cap (only chunks ever
        # prefill); max_prompt just sizes the first-chunk bucket and
        # must stay below the cache length
        chunk_b = ((args.serve_prefill_chunk + 63) // 64) * 64
        max_prompt = min(max(longest, chunk_b), max(
            64, ((mcfg.n_positions - args.serve_sync - 2) // 64) * 64))
    elif longest + args.serve_sync >= mcfg.n_positions:
        raise ValueError(
            f"longest request prompt buckets to {longest} tokens, but "
            f"serving needs prompt + sync_every < n_positions "
            f"({mcfg.n_positions}); shorten the prompt, or pass "
            f"--serve_prefill_chunk to admit long prompts in chunks")
    # logical cache length: with per-slot cursors the physical rung
    # tracks max(active length), so a full-context cache costs nothing
    # until requests grow into it; --max_len below n_positions still
    # caps it (submit rejects requests that cannot fit, loudly)
    cache_len = min(mcfg.n_positions,
                    max(cfg.max_len, longest + args.serve_sync + 1,
                        max_prompt + 1))
    long_threshold = args.serve_long_threshold
    if args.serve_long_slots and long_threshold is None:
        # the library default (max_prompt) is the LONGEST prompt's bucket
        # here, which would route every request short: route roughly the
        # long pool's slot share of the traffic long, the (1 - K/S)
        # quantile of expected final lengths (prompt + max_new - 1, the
        # final KV cursor), bucketed down
        exp = sorted(len(q.prompt_ids) + q.max_new_tokens - 1
                     for q, _ in reqs)
        if exp:
            frac = 1.0 - args.serve_long_slots / max(cfg.batch_size, 1)
            q_ix = min(int(len(exp) * frac), len(exp) - 1)
            long_threshold = max(64, (exp[q_ix] // 64) * 64)
            print(f"--serve_long_threshold not set; using "
                  f"{long_threshold} (the {100 * frac:.0f}th percentile "
                  f"of expected final lengths in the requests file)")
    srv = ContinuousServer(
        params, mcfg, slots=cfg.batch_size, eos_id=st.eos_id,
        sp2_id=st.sp2_id, max_prompt=max_prompt, cache_len=cache_len,
        sync_every=args.serve_sync,
        pipeline=args.serve_pipeline,
        spec_gamma=args.serve_spec_gamma,
        spec_ngram=args.serve_spec_ngram,
        prefill_chunk=args.serve_prefill_chunk,
        long_slots=args.serve_long_slots,
        long_threshold=long_threshold,
        # the offline regime: length-sorted cohorts
        admit_policy=args.serve_admit_policy or "sorted", mesh=mesh)
    if not primary:  # rank 0 submits; this rank steps with it until it stops
        srv.follow()
        return

    order = sorted(range(len(reqs)), key=lambda i: reqs[i][1])
    rid_to_idx = {}
    rejected = {}  # index -> error message (a bad request does not end the run)
    t0 = time.time()
    nxt = 0
    try:
        while len(srv.results) < len(reqs) - len(rejected):
            now = time.time() - t0
            while nxt < len(reqs) and reqs[order[nxt]][1] <= now:
                idx = order[nxt]
                try:
                    rid_to_idx[srv.submit(reqs[idx][0])] = idx
                except ValueError as e:
                    # e.g. prompt + budget exceeds the model context: record
                    # the rejection and keep serving the rest of the file
                    rejected[idx] = str(e)
                    print(f"WARNING: request {idx} rejected: {e}")
                nxt += 1
            if not srv.busy():
                if srv.in_flight():
                    srv.flush()  # a pipelined in-flight block still harvests
                srv.heartbeat()  # the followers wait for the next arrival
                time.sleep(0.002)
                continue
            srv.step()
        wall = time.time() - t0
    finally:
        srv.stop_followers()

    out_path = args.serve_output or args.requests_file + ".responses.jsonl"
    rows = [{"index": idx, "error": msg} for idx, msg in rejected.items()]
    for rid, res in srv.results.items():
        row = {"index": rid_to_idx[rid], "tokens": res.tokens,
               "emotion_id": int(np.argmax(res.emotion_logits)),
               "latency_s": round(res.latency_s, 3)}
        if res.logprobs is not None:
            row["logprobs"] = [round(x, 5) for x in res.logprobs]
        if tokenizer is not None:
            stop = res.tokens[:-1] if (res.tokens and
                                       res.tokens[-1] == st.eos_id) \
                else res.tokens
            row["text"] = tokenizer.decode(stop)
        rows.append(row)
    with open(out_path, "w") as f:
        for row in sorted(rows, key=lambda r: r["index"]):
            f.write(json.dumps(row) + "\n")
    print(f"Served {len(reqs)} requests in {wall:.1f}s "
          f"({len(reqs) / max(wall, 1e-9):.1f} req/s) -> {out_path}")
    if srv.spec_proposed:
        print(f"speculative: {srv.spec_accepted}/{srv.spec_proposed} drafts "
              f"accepted ({srv.spec_accepted / srv.spec_proposed:.0%})")


def run_interact(cfg: TrainConfig, args, mesh=None, device=None):
    """--mode=interact: the dialogue REPL on stdin (rank 0's, over a mesh).
    ``run_repl`` takes no speculative mode: JAX's CLI passes ``spec_mode``
    and ``spec_ngram`` to a ``run_repl`` that does not accept them (its
    interact mode raises TypeError); this one passes what ``run_repl``
    takes."""
    from ergm_tpu_torch.data.assembly import read_meta
    from ergm_tpu_torch.infer.interact import run_repl

    if not cfg.tokenizer_dir:
        raise SystemExit("interact mode needs --tokenizer_dir")
    st = read_meta(cfg.data_dir)
    mcfg = ModelConfig.from_model_type(cfg.model_type, vocab_size=st.vocab_size,
                                       dtype=cfg.dtype, weight_dtype=args.weight_dtype)
    device = device_of(args) if device is None else device
    params = _place_params(_serving_params(cfg, mcfg, device, seed=cfg.seed, required=False),
                           mesh)
    tokenizer = _load_tokenizer(cfg.tokenizer_dir, st)
    run_repl(params, mcfg, st, tokenizer, max_len=cfg.max_len, max_turns=cfg.max_turns,
             top_p=cfg.top_p, seed=cfg.seed, draft_layers=args.draft_layers,
             spec_gamma=args.spec_gamma, mesh=mesh)


if __name__ == "__main__":
    main()
