"""Port parity: ergm_tpu_torch's test runner (``infer/runner.py``), REPL
(``infer/interact.py``) and evaluation (``evaluation/*``) against
ergm_tpu's.

``run_test`` runs a tiny fp32 model with captions, image and audio
features over a synthetic split (``data/synthetic.py``), at
``top_p=1e-9`` with the full-sort sampler (greedy in both packages):
references, true labels, contexts and supervised-token counts equal
JAX's, losses within 1e-4, and each row's hypothesis equals JAX's up to
its first step whose top-2 logit margin is 1e-3 or less (the emotion
label where its logits' margin exceeds 1e-3). Margins are read on the
port's side, whose fp32 logits are JAX's to ~1e-5. Beam search is held
to the beam margin rule of tests/test_torch_beam.py.
"""
import io
import math
import os
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.data.dataset import DialogueDataset as JaxDataset
from ergm_tpu.evaluation import evaluate as jeval
from ergm_tpu.infer import interact as jinteract
from ergm_tpu.infer import runner as jrunner
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.core.mesh import make_mesh
from ergm_tpu_torch.core.tokens import SpecialTokens
from ergm_tpu_torch.data.assembly import read_meta
from ergm_tpu_torch.data.dataset import DialogueDataset
from ergm_tpu_torch.data.synthetic import write_synthetic_dataset
from ergm_tpu_torch.evaluation import evaluate as teval
from ergm_tpu_torch.infer import beam as tbeam
from ergm_tpu_torch.infer import generate as tgen
from ergm_tpu_torch.infer import interact as tinteract
from ergm_tpu_torch.infer import runner as trunner
from ergm_tpu_torch.models.convert import params_from_numpy
from ergm_tpu_torch.tokenizer.bpe import train_bpe

torch.set_num_threads(1)
MARGIN = 1e-3
MAX_LEN, NEW, BATCH = 128, 8, 5
MODEL = dict(n_layer=2, n_embd=64, n_head=2, n_positions=MAX_LEN, dtype="float32",
             embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


def _models(vocab_size, seed=0, **over):
    kw = dict(MODEL, vocab_size=vocab_size, **over)
    jc, tc = JaxConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.02, x.shape).astype(np.float32),
        jg.init_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, tc, "cpu")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """12 examples with random captions: batches of 5, 5 and 2 (+3 fill rows)."""
    d = str(tmp_path_factory.mktemp("synthetic"))
    write_synthetic_dataset(d, prefixes=("valid",), num_dialogues=3, turns_per_dialogue=4,
                            captions="random", seed=3)
    st = read_meta(d)
    kw = dict(sp1_id=st.sp1_id, sp2_id=st.sp2_id, eos_id=st.eos_id, max_len=MAX_LEN)
    tds, jds = DialogueDataset("valid", d, **kw), JaxDataset("valid", d, **kw)
    assert len(tds) == len(jds) == 12
    return st, tds, jds, _models(st.vocab_size)


class _Record:
    """Per ``generate_batch`` / ``beam_search_batch`` call of the port's
    runner: the gap of each decision, in order, per row (greedy: the
    top-2 margin of every step; beam: every W-th against (W+1)-th
    candidate score, then the best against the second final score) and
    the emotion logits."""

    def __init__(self, monkeypatch):
        self.gaps, self.emotion = [], []
        real_gen, real_beam = trunner.generate_batch, trunner.beam_search_batch
        real_filter, real_top_k, real_finish = tgen.top_p_filter, tbeam._top_k, tbeam.beam_finish

        def called(real):
            def run(params, config, prompts, **kw):
                self.gaps.append([])
                outs, emo = real(params, config, prompts, **kw)
                self.emotion.append(emo)
                return outs, emo
            return run

        def note(gap):
            self.gaps[-1].append(gap)

        def top_p_filter(probs, top_p):
            top2 = torch.topk(probs, 2, dim=-1).values.double().log()
            note((top2[:, 0] - top2[:, 1]).numpy())
            return real_filter(probs, top_p)

        def top_k(x, k):
            vals = torch.sort(x, dim=-1, descending=True).values
            note((vals[:, k - 1] - vals[:, k]).numpy())
            return real_top_k(x, k)

        def finish(s, rows, length_penalty):
            stop = (s.tokens == rows.eos_id) & (torch.arange(s.tokens.shape[-1]) >= rows.Lp)
            lengths = torch.where(stop.any(-1), stop.int().argmax(-1) + 1, s.tokens.shape[-1])
            final = s.scores / torch.clamp_min((lengths - rows.Lp).float(), 1.0) ** length_penalty
            top2 = torch.sort(final, dim=-1, descending=True).values[:, :2]
            note((top2[:, 0] - top2[:, 1]).numpy())
            return real_finish(s, rows, length_penalty)

        monkeypatch.setattr(trunner, "generate_batch", called(real_gen))
        monkeypatch.setattr(trunner, "beam_search_batch", called(real_beam))
        monkeypatch.setattr(tgen, "top_p_filter", top_p_filter)
        monkeypatch.setattr(tbeam, "_top_k", top_k)
        monkeypatch.setattr(tbeam, "beam_finish", finish)


def _compare(got, want, rec, greedy: bool) -> int:
    """Field by field. A row whose every decision was taken by a gap above
    MARGIN must equal JAX's; greedy, another row must equal JAX's up to its
    first step at MARGIN or less. Returns the number of whole rows."""
    for field in ("references", "true_labels", "contexts", "loss_tokens"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-4, rtol=0)
    # [rows, decisions]: each call's decisions, its rows stacked
    steps = [np.stack(g, axis=1) for g in rec.gaps]
    width = max(x.shape[1] for x in steps)
    gaps = np.concatenate([np.pad(x, ((0, 0), (0, width - x.shape[1])), constant_values=np.inf)
                           for x in steps])
    emo = np.concatenate(rec.emotion)
    top2 = np.sort(emo, axis=-1)[:, -2:]
    emo_decided = top2[:, 1] - top2[:, 0] > MARGIN
    assert emo_decided.sum() >= len(emo) // 2
    for b in np.flatnonzero(emo_decided):
        assert got.pred_labels[b] == want.pred_labels[b], b
    assert len(got.hypotheses) == len(want.hypotheses) == len(gaps)
    decided = 0
    for b, (g, w) in enumerate(zip(got.hypotheses, want.hypotheses)):
        close = np.flatnonzero(gaps[b] <= MARGIN)
        if not len(close):
            assert g == w, b
            decided += 1
        elif greedy:
            k = int(close[0])
            print(f"row {b}: step {k} decided by a margin of {gaps[b, k]:.2e}; compared up to it")
            assert g.split()[:k] == w.split()[:k], b
        else:
            print(f"row {b}: a beam decision gap of {gaps[b].min():.2e}; not asserted")
    assert decided >= len(gaps) // 2
    return decided


def _run(split, monkeypatch, **kw):
    st, tds, jds, (jc, tc, pj, pt) = split
    common = dict(batch_size=BATCH, eos_id=st.eos_id, sp2_id=st.sp2_id, max_len=MAX_LEN,
                  top_p=1e-9, max_new_tokens=NEW, **kw)
    want = jrunner.run_test(pj, jc, jds, **common)
    rec = _Record(monkeypatch)
    got = trunner.run_test(pt, tc, tds, **common)
    return got, want, rec


@pytest.mark.parametrize("prompt_mode", ["reference", "history"])
def test_run_test_greedy_matches_jax(split, monkeypatch, prompt_mode):
    got, want, rec = _run(split, monkeypatch, prompt_mode=prompt_mode)
    assert len(rec.gaps) == 3  # batches of 5, 5 and 2 real rows
    _compare(got, want, rec, greedy=True)
    assert all(len(h.split()) <= NEW for h in got.hypotheses)


def test_run_test_beam_matches_jax(split, monkeypatch):
    got, want, rec = _run(split, monkeypatch, num_beams=2)
    _compare(got, want, rec, greedy=False)


def test_run_test_refuses_what_is_not_ported(split):
    st, tds, _, (_, tc, _, pt) = split
    kw = dict(batch_size=BATCH, eos_id=st.eos_id, sp2_id=st.sp2_id, max_len=MAX_LEN, top_p=0.8)
    with pytest.raises(ValueError, match="exact top-k"):
        trunner.run_test(pt, tc, tds, sampler="approx", **kw)
    # a model axis needs a world (a mesh laid out without one)
    tp = make_mesh((1, 2), ("data", "model"), world_size=2, rank=0)
    with pytest.raises(ValueError, match="needs a torch.distributed world"):
        trunner.run_test(pt, tc, tds, mesh=tp, **kw)


def test_write_generations_matches_jax(tmp_path):
    rows = (["ctx a", "ctx b"], ["ref a", "ref b"], ["hyp a", "hyp b"])
    trunner.write_generations(str(tmp_path / "t.txt"), *rows)
    jrunner.write_generations(str(tmp_path / "j.txt"), *rows)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert trunner.format_sample("c", "r", "h") == jrunner.format_sample("c", "r", "h")


def test_repl_windows_match_jax(monkeypatch):
    """Three turns through ``run_repl``: each prompt window (ids and token
    types) equals JAX's ``DialogueSession._window`` over the same turns."""
    tok = train_bpe(["hello there how are you doing today my friend"] * 3, vocab_size=300)
    vocab = dict(tok.vocab)
    st = SpecialTokens.register(vocab)
    tok.add_special_tokens([t for t in vocab if t not in tok.vocab])
    _, tc, _, pt = _models(st.vocab_size, seed=1, n_positions=64, use_cross_attention=False)
    windows, replies = [], []
    real = tinteract.generate_batch

    def recording(params, config, prompts, **kw):
        outs, emo = real(params, config, prompts, **kw)
        windows.append((prompts[0], kw["token_types"][0]))
        replies.append([t for t in outs[0] if t != st.eos_id])
        return outs, emo
    monkeypatch.setattr(tinteract, "generate_batch", recording)
    out = io.StringIO()
    lines = ["hello there", "how are you doing", "today my friend"]
    tinteract.run_repl(pt, tc, st, tok, max_len=64, max_turns=2, top_p=0.9,
                       stdin=io.StringIO("\n".join(lines) + "\n\n"), stdout=out)
    text = out.getvalue()
    assert text.count("model>") == 3 and "[error" not in text and "bye." in text
    session = jinteract.DialogueSession(None, JaxConfig(**MODEL, vocab_size=st.vocab_size,
                                                        use_cross_attention=False),
                                        st, tok, max_len=64, max_turns=2)
    for line, reply, window in zip(lines, replies, windows):
        session.turns.append(tok.encode(line))
        prompt, tts = session._window()
        assert window == (prompt, tts)
        session.turns.append(reply)
    tp = make_mesh((1, 2), ("data", "model"), world_size=2, rank=0)
    with pytest.raises(ValueError, match="needs a torch.distributed world"):
        tinteract.DialogueSession(pt, tc, st, tok, mesh=tp).reply("hello there")


# -- evaluation --------------------------------------------------------------

HYPS = ["i am so sorry to hear that .", "that sounds great !", "what happened ?",
        "i don't know what to say", "that's wonderful news , congrats !"]
REFS = ["oh no , i am sorry .", "that sounds like fun !", "what happened then ?",
        "i don't know either", "congrats on the news !"]


def _embed(texts):
    """A deterministic token-embedding stand-in (hash of each word)."""
    out = []
    for t in texts:
        words = t.split() or [""]
        out.append(np.stack([np.random.default_rng(abs(hash(w)) % 2**32).standard_normal(8)
                             for w in words]))
    return out


def test_evaluate_all_matches_jax():
    kw = dict(true_label_ids=[0, 3, 4, 4, 6], pred_label_ids=[0, 3, 2, 4, 1],
              losses=[2.5, 3.25, 1.75], loss_token_counts=[40.0, 12.0, 30.0])
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = teval.Evaluator().evaluate_all(HYPS, REFS, **kw)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        want = jeval.Evaluator().evaluate_all(HYPS, REFS, **kw)
    assert any("BERTScore SKIPPED" in str(w.message) for w in wt)
    assert set(got) == set(want) and "bs_f1" not in got
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=1e-12), k
    got = teval.Evaluator(embed_fn=_embed).evaluate_all(HYPS, REFS)
    want = jeval.Evaluator(embed_fn=_embed).evaluate_all(HYPS, REFS)
    assert set(got) == set(want) and "bs_f1" in got
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=1e-12), k
    assert teval.word_tokenize("I don't know.") == jeval.word_tokenize("I don't know.")
    with pytest.raises(RuntimeError, match="BERTScore required"):
        teval.Evaluator(require_bertscore=True).evaluate_all(HYPS, REFS)


BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "i", "am", "so", "sorry", "to",
              "hear", "that", ".", "sounds", "great", "!", "what", "happened", "?", "oh", "no",
              ",", "like", "fun", "then", "congrats", "news", "the", "on"]


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A tiny random-weight BERT checkpoint on disk (importing
    transformers' model modules takes ~10 s here)."""
    transformers = pytest.importorskip("transformers")
    d = str(tmp_path_factory.mktemp("bert"))
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(BERT_VOCAB))
    transformers.BertTokenizer(os.path.join(d, "vocab.txt")).save_pretrained(d)
    cfg = transformers.BertConfig(vocab_size=len(BERT_VOCAB), hidden_size=32,
                                  num_hidden_layers=3, num_attention_heads=4,
                                  intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    transformers.BertModel(cfg).save_pretrained(d)
    return d


def test_bertscorer_matches_jax(bert_dir):
    from ergm_tpu.evaluation.bertscore import BERTScorer as JaxScorer
    from ergm_tpu_torch.evaluation.bertscore import BERTScorer

    d = bert_dir
    for kw in (dict(layer=2), dict(layer=3, idf=True, baselines={"f1": 0.3, "precision": 0.2})):
        got = BERTScorer(d, device="cpu", **kw).score(HYPS, REFS)
        want = JaxScorer(d, **kw).score(HYPS, REFS)
        assert set(got) == set(want) == {"bs_precision", "bs_recall", "bs_f1"}
        for k in want:
            assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=1e-12), k


def test_evaluator_bertscore_matches_jax_and_runs_on_the_card_by_default(bert_dir):
    """``Evaluator(bert_model_dir=...)`` hands its ``device`` to the scorer:
    on the CPU its ``bs_*`` fields equal JAX's; left at its default it asks
    for the card, and is refused where there is none."""
    from ergm_tpu_torch.evaluation.bertscore import BERTScorer

    kw = dict(bert_layer=2, bert_idf=True)
    got = teval.Evaluator(bert_model_dir=bert_dir, device="cpu", **kw).evaluate_all(HYPS, REFS)
    want = jeval.Evaluator(bert_model_dir=bert_dir, **kw).evaluate_all(HYPS, REFS)
    assert set(got) == set(want) and "bs_f1" in got
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=1e-12), k
    if torch.cuda.is_available():
        assert BERTScorer(bert_dir, layer=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            teval.Evaluator(bert_model_dir=bert_dir)
