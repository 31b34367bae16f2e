"""The port's command line (``ergm_tpu_torch/cli``) against ``ergm_tpu``'s
on one synthetic workspace, fp32 on the CPU (``--gpu=cpu``), dropout 0,
a 2-layer, 32-wide model ("tiny").

Both CLIs build the data, then train 2 epochs from the same weights
(JAX's from an orbax save of a JAX init, the port's from the same numpy
tree through ``params_from_numpy``): both take the same batches (checked
first), the saved parameters agree within 2e-3 (PARITY.md:43-49) and the
valid PPLs within 1e-4 relative. JAX's checkpoint reaches the port
through ``ergm_tpu.cli.convert_ckpt --reverse`` and the port's
``convert_ckpt``: logits within 1e-4 of JAX's. From those weights
``--mode=infer`` gives the same PPL (1e-4 relative) and emotion accuracy,
and ``--mode=serve`` the same greedy tokens wherever the top-2 logit
margin exceeds 1e-3. The HTTP front end gets ``--top_p`` and ``--seed``
as request defaults in both packages. ``--mode=interact`` runs two turns
(JAX's raises TypeError: its CLI passes ``run_repl`` keywords it does not
take). Several devices are refused.
"""
import io
import json
import os
import re
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import torch

from ergm_tpu.cli import convert_ckpt as jax_convert
from ergm_tpu.cli import load_data as jax_load_data
from ergm_tpu.cli import main as jax_cli
from ergm_tpu.core import config as jax_config
from ergm_tpu.data import dataset as jax_dataset
from ergm_tpu.models import gpt2 as jg
from ergm_tpu.train import checkpoint as jax_ckpt
from ergm_tpu_torch.cli import convert_ckpt as port_convert
from ergm_tpu_torch.cli import load_data as port_load_data
from ergm_tpu_torch.cli import main as port_cli
from ergm_tpu_torch.core import config as port_config
from ergm_tpu_torch.data import dataset as port_dataset
from ergm_tpu_torch.data.assembly import read_meta
from ergm_tpu_torch.models import gpt2 as tg
from ergm_tpu_torch.models.convert import params_from_numpy
from ergm_tpu_torch.train import checkpoint as port_ckpt

torch.set_num_threads(1)

TINY = dict(n_layer=2, n_head=4, n_embd=32)
COMMON = ["--data_dir=data", "--model_type=tiny", "--batch_size=4", "--max_len=64",
          "--dtype=float32", "--mesh_shape=1", "--lr=1e-3", "--attn_pdrop=0",
          "--resid_pdrop=0", "--embd_pdrop=0"]


def _run(main, ws, argv):
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The workspace: both load_data CLIs (byte-equal output), a JAX init
    saved for each package, both CLIs trained 2 epochs from it."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_config.GPT2_SIZES, "tiny", TINY)
    mp.setitem(port_config.GPT2_SIZES, "tiny", TINY)
    ws = tmp_path_factory.mktemp("ws")
    for pkg, main in (("jax", jax_load_data.main), ("port", port_load_data.main)):
        main(["--source=synthetic", f"--data_dir={ws / pkg}", "--model_type=tiny",
              "--num_dialogues=4", "--turns=3"])
    for name in os.listdir(ws / "jax" / "tiny"):
        assert (ws / "jax" / "tiny" / name).read_bytes() == \
            (ws / "port" / "tiny" / name).read_bytes(), name
    os.rename(ws / "port", ws / "data")
    st = read_meta(str(ws / "data" / "tiny"))

    tree = jax.tree_util.tree_map(np.asarray, jg.init_params(
        jax.random.PRNGKey(3), jax_config.ModelConfig.from_model_type(
            "tiny", vocab_size=st.vocab_size, dtype="float32")))
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as c:
        c.save(str(ws / "jax_init"), {"params": tree}, force=True)
    pcfg = port_config.ModelConfig.from_model_type("tiny", vocab_size=st.vocab_size,
                                                   dtype="float32")
    torch.save({"params": params_from_numpy(tree, pcfg, device="cpu").state_dict()},
               ws / "port_init.pt")

    out = {}
    for pkg, main, extra in (
            ("jax", jax_cli.main, ["--init_params=jax_init"]),
            ("port", port_cli.main, ["--init_params=port_init.pt", "--gpu=cpu", "--layers=0"])):
        buf = io.StringIO()
        real, sys.stdout = sys.stdout, buf
        try:
            _run(main, ws, ["--mode=train", "--num_epochs=2", f"--ckpt_dir={pkg}_models",
                            f"--output_dir={pkg}_out", *extra, *COMMON])
        finally:
            sys.stdout = real
        out[pkg] = buf.getvalue()
    yield ws, st, out
    mp.undo()


def test_batches_equal_jax(ws):
    """The train loop's batches (shuffled per epoch, partial batch dropped)
    are JAX's: the cause to rule out before comparing training."""
    ws, st, _ = ws
    kw = dict(data_dir=str(ws / "data" / "tiny"), sp1_id=st.sp1_id, sp2_id=st.sp2_id,
              eos_id=st.eos_id, max_len=64)
    jds = jax_dataset.DialogueDataset("train", **kw)
    pds = port_dataset.DialogueDataset("train", **kw)
    for epoch in (1, 2):
        bk = dict(shuffle=True, seed=epoch, max_len=64, drop_remainder=True)
        jb = list(jax_dataset.batches(jds, 4, st.eos_id, **bk))
        pb = list(port_dataset.batches(pds, 4, st.eos_id, **bk))
        assert len(jb) == len(pb) == len(jds) // 4
        for a, b in zip(jb, pb):
            for f in ("input_ids", "token_type_ids", "labels", "imgs", "emotion_labels"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _valid_ppls(text):
    return [float(x) for x in re.findall(r"Valid PPL: ([0-9.]+)", text)]


def test_train_matches_jax(ws):
    """2 epochs through both CLIs: valid PPLs within 1e-4 relative, the
    best checkpoints' parameters within 2e-3."""
    ws, st, out = ws
    jp, pp = _valid_ppls(out["jax"]), _valid_ppls(out["port"])
    assert len(jp) == len(pp) == 2
    np.testing.assert_allclose(pp, jp, rtol=1e-4)
    jpath = jax_ckpt.find_checkpoint(str(ws / "jax_models" / "tiny"))
    ppath = port_ckpt.find_checkpoint(str(ws / "port_models" / "tiny"))
    assert os.path.basename(jpath).split("_valid")[0] == os.path.basename(ppath).split("_valid")[0]
    jcfg = jax_config.ModelConfig.from_model_type("tiny", vocab_size=st.vocab_size,
                                                  dtype="float32")
    jtree = jax_ckpt.restore_params(jpath, jg.init_params(jax.random.PRNGKey(0), jcfg))
    pcfg = port_config.ModelConfig.from_model_type("tiny", vocab_size=st.vocab_size,
                                                   dtype="float32")
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), pcfg, device="cpu")
    got = port_ckpt.restore_params(ppath, tg.init_params(torch.Generator().manual_seed(0),
                                                         pcfg, device="cpu"))
    for (name, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3, rtol=0, err_msg=name)
    assert os.listdir(ws / "port_out" / "tb")  # TensorBoard scalars written


@pytest.fixture(scope="module")
def converted(ws):
    """JAX's best checkpoint -> ergm_tpu.cli.convert_ckpt --reverse -> the
    port's convert_ckpt -> a port checkpoint directory
    ``conv_models/tiny/converted``."""
    ws, st, _ = ws
    jpath = jax_ckpt.find_checkpoint(str(ws / "jax_models" / "tiny"))
    jax_convert.main([f"--src={jpath}", f"--dst={ws / 'hf.pt'}", "--reverse",
                      "--model_type=tiny"])
    dst = ws / "conv_models" / "tiny" / "converted"
    dst.mkdir(parents=True)
    port_convert.main([f"--src={ws / 'hf.pt'}", f"--dst={dst / 'state.pt'}",
                       "--model_type=tiny"])
    return jpath, dst


def test_jax_checkpoint_reaches_the_port(ws, converted):
    """Logits of the converted weights within 1e-4 of JAX's, and the
    port's --reverse then forward conversion gives the parameters back
    bit for bit."""
    ws, st, _ = ws
    jpath, dst = converted
    jcfg = jax_config.ModelConfig.from_model_type("tiny", vocab_size=st.vocab_size,
                                                  dtype="float32")
    jparams = jax_ckpt.restore_params(jpath, jg.init_params(jax.random.PRNGKey(0), jcfg))
    pcfg = port_config.ModelConfig.from_model_type("tiny", vocab_size=st.vocab_size,
                                                   dtype="float32")
    params = port_ckpt.restore_params(str(dst), tg.init_params(
        torch.Generator().manual_seed(9), pcfg, device="cpu"))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, st.vocab_size, (2, 24))
    tts = rng.integers(0, st.vocab_size, (2, 24))
    want = jg.forward(jparams, jcfg, jax.numpy.asarray(ids), token_type_ids=jax.numpy.asarray(tts))
    with torch.no_grad():
        got = tg.forward(params, pcfg, torch.as_tensor(ids), token_type_ids=torch.as_tensor(tts))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=0)

    port_convert.main([f"--src={dst}", f"--dst={ws / 'hf2.pt'}", "--reverse",
                       "--model_type=tiny"])
    port_convert.main([f"--src={ws / 'hf2.pt'}", f"--dst={ws / 'back.pt'}",
                       "--model_type=tiny"])
    back = torch.load(ws / "back.pt", weights_only=True)["params"]
    for name, p in params.state_dict().items():
        assert torch.equal(back[name], p), name


def _results(path):
    return dict(line.split(": ", 1) for line in open(path).read().splitlines())


def test_infer_matches_jax(ws, converted):
    """--mode=infer from the same weights: PPL within 1e-4 relative and the
    same emotion accuracy; both files written, with the decode lines."""
    ws, st, _ = ws
    args = ["--mode=infer", "--top_p=0.8", *COMMON]
    _run(jax_cli.main, ws, ["--ckpt_dir=jax_models", "--ckpt_name=best", *args])
    _run(port_cli.main, ws, ["--ckpt_dir=conv_models", "--ckpt_name=converted", "--gpu=cpu",
                             *args])
    d = ws / "data" / "tiny"
    want = _results(d / "best_evaluation_results.txt")
    got = _results(d / "converted_evaluation_results.txt")
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got["ppl"]), float(want["ppl"]), rtol=1e-4)
    assert got["emotion_acc"] == want["emotion_acc"]
    assert (got["top_p"], got["sampler"]) == ("0.8", "full_sort")
    assert (d / "converted_generations.txt").read_text().count("GPT-2:") == \
        (d / "best_generations.txt").read_text().count("GPT-2:")


def test_serve_greedy_matches_jax(ws, converted):
    """--mode=serve over a requests file from the same weights: every
    greedy row equals JAX's up to its first step whose top-2 margin (the
    port's logits along JAX's tokens) is 1e-3 or less."""
    ws, st, _ = ws
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50, (n,)).tolist() for n in (5, 9, 14, 7, 11)]
    with open(ws / "requests.jsonl", "w") as f:
        for p in prompts:
            f.write(json.dumps({"prompt": p, "max_new_tokens": 6, "greedy": True}) + "\n")
    args = ["--mode=serve", "--serve_sync=2", "--requests_file=requests.jsonl", *COMMON]
    _run(jax_cli.main, ws, ["--ckpt_dir=jax_models", "--ckpt_name=best",
                            "--serve_output=jax.jsonl", *args])
    _run(port_cli.main, ws, ["--ckpt_dir=conv_models", "--ckpt_name=converted", "--gpu=cpu",
                             "--serve_output=port.jsonl", *args])
    want = [json.loads(x) for x in open(ws / "jax.jsonl")]
    got = [json.loads(x) for x in open(ws / "port.jsonl")]
    assert [r["index"] for r in got] == [r["index"] for r in want] == list(range(5))

    pcfg = port_config.ModelConfig.from_model_type("tiny", vocab_size=st.vocab_size,
                                                   dtype="float32")
    params = port_ckpt.restore_params(
        str(ws / "conv_models" / "tiny" / "converted"),
        tg.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu"))
    for p, g, w in zip(prompts, got, want):
        seq = p + w["tokens"]
        ids = torch.tensor([seq])
        with torch.no_grad():
            logits = tg.forward(params, pcfg, ids,
                                token_type_ids=torch.full_like(ids, st.sp2_id)).logits[0]
        top2 = torch.topk(logits[len(p) - 1:len(seq) - 1], 2, dim=-1).values
        close = np.flatnonzero((top2[:, 0] - top2[:, 1]).numpy() <= 1e-3)
        k = int(close[0]) if len(close) else None
        assert g["tokens"][:k] == w["tokens"][:k], (g, w, k)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_serve_http_defaults_reach_the_request(ws, pkg, monkeypatch):
    """--serve_http: a POST without top_p or seed gets --top_p and --seed
    (the Request that reaches the server's submit)."""
    ws, st, _ = ws
    if pkg == "jax":
        from ergm_tpu.infer import http_server, server
        main = jax_cli.main
        extra = []
    else:
        from ergm_tpu_torch.infer import http_server, server
        main = port_cli.main
        extra = ["--gpu=cpu"]
    seen = []

    def submit(self, req):
        seen.append(req)
        raise ValueError("recorded")

    def serve_forever(fe):
        try:
            req = urllib.request.Request(
                f"http://{fe.host}:{fe.port}/generate", data=json.dumps({"prompt": [5, 6, 7]})
                .encode(), headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(req, timeout=60)
        finally:
            fe.close()

    monkeypatch.setattr(server.ContinuousServer, "submit", submit)
    monkeypatch.setattr(http_server.ServerFrontend, "serve_forever", serve_forever)
    _run(main, ws, ["--mode=serve", "--serve_http=0", "--top_p=0.8", "--seed=7",
                    "--ckpt_dir=nowhere", *extra, *COMMON])
    assert len(seen) == 1
    assert (seen[0].top_p, seen[0].seed, seen[0].max_new_tokens) == (pytest.approx(0.8), 7, 128)


def test_interact_runs_two_turns(ws, tmp_path, monkeypatch, capsys):
    """--mode=interact on a BPE tokenizer through the port's CLI: two
    scripted turns, then an empty line ends it. JAX's CLI raises
    TypeError there (it passes spec_mode/spec_ngram to its run_repl)."""
    from ergm_tpu_torch.core.tokens import SpecialTokens
    from ergm_tpu_torch.data.assembly import write_meta
    from ergm_tpu_torch.tokenizer.bpe import train_bpe

    tok = train_bpe(["hello there how are you doing today my friend"] * 3, vocab_size=300)
    tok.save(str(tmp_path / "tok"))
    full = SpecialTokens.register(dict(tok.vocab))
    write_meta(full, str(tmp_path / "data" / "tiny"))
    argv = ["--mode=interact", f"--tokenizer_dir={tmp_path / 'tok'}", "--ckpt_dir=nowhere",
            "--top_p=0.9", *COMMON]
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello there\nhow are you\n\n"))
    _run(port_cli.main, tmp_path, ["--gpu=cpu", *argv])
    text = capsys.readouterr().out
    assert text.count("model>") == 2 and "[error" not in text and "bye." in text
    with pytest.raises(TypeError, match="spec_mode"):
        _run(jax_cli.main, tmp_path, argv)


@pytest.mark.parametrize("argv,env", [
    (["--mesh_shape=2", "--batch_size=3"], {}),
    (["--mesh_shape=4,2", "--mesh_axes=data,model", "--batch_size=6"], {}),
    (["--shard_opt_state", "--mesh_shape=3"], {}),
    ([], {"ERGM_COORDINATOR": "localhost:1234", "ERGM_NUM_PROCESSES": "2"}),
])
def test_several_devices_are_refused(argv, env, monkeypatch):
    """``--mode=infer`` serves over several devices (tests/test_torch_mesh_infer.py)
    and refuses what JAX's CLI refuses, before any process starts: an
    explicit mesh whose data axis does not divide the batch (ZeRO-1 has no
    meaning at inference and changes nothing), and a partial launcher
    environment."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    match = "Partial multi-host" if env else "must be divisible by the mesh data axis"
    with pytest.raises(ValueError, match=match):
        port_cli.main(["--mode=infer", "--gpu=cpu", "--ckpt_name=x", *argv])


def test_gpu_index_without_a_card_fails(ws):
    """--gpu=0 (the default) on a machine without a card fails; it does
    not land on the CPU."""
    ws, _, _ = ws
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        _run(port_cli.main, ws, ["--mode=train", "--num_epochs=1", "--ckpt_dir=gpu_models",
                                 *COMMON])


def test_flags_and_defaults_equal_jax():
    """Every flag of ergm_tpu/cli/main.py:24-258 with its name, default and
    choices."""
    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required)
                for a in p._actions}
    assert flags(port_cli.build_argparser()) == flags(jax_cli.build_argparser())
    args = port_cli.build_argparser().parse_args(["--mode=train"])
    cfg = port_cli.args_to_config(args)
    assert (cfg.mesh_shape, cfg.num_workers, cfg.grad_accum_steps, args.gpu) == \
        ((-1,), 0, 1, "0")
    assert port_cli.device_of(port_cli.build_argparser().parse_args(
        ["--mode=train", "--gpu=cpu"])) == torch.device("cpu")


def test_new_modules_import_no_jax():
    """The modules this slice adds import without JAX or ergm_tpu (checked
    in a fresh interpreter: this process has JAX loaded)."""
    import subprocess

    mods = ["cli.main", "cli.load_data", "cli.convert_ckpt", "tools.labels", "tools.labels_csv",
            "tools.labels_iemocap", "tools.corpora", "data.loader"]
    code = ("import sys; " + "; ".join(f"import ergm_tpu_torch.{m}" for m in mods) + "; "
            "ergm_tpu_torch.cli.main.build_argparser(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ergm_tpu')]; "
            "assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
