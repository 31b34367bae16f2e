"""Port parity: ergm_tpu_torch.models.convert, gpt2.prune_heads and
gpt2.resize_token_embeddings.

A locally built, randomly initialised HF GPT-2 (no download) is
converted by both packages; fp32 logits, emotion logits and the joint
loss of the port must match HF's and ``ergm_tpu``'s within 1e-3
(``tests/test_torch_parity.py``'s bar), with cross-attention on and off.
The HF state dict round-trips, and pruned and resized models match
JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.models import convert as jconv
from ergm_tpu.models import gpt2 as jg
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.models import convert as tconv
from ergm_tpu_torch.models import gpt2 as tg

torch.set_num_threads(1)
VOCAB, POS, EMBD, LAYER, HEAD = 128, 64, 32, 2, 4
TOL = 1e-3
T = torch.as_tensor


def make_hf(add_cross):
    cfg = transformers.GPT2Config(
        vocab_size=VOCAB, n_positions=POS, n_embd=EMBD, n_layer=LAYER, n_head=HEAD,
        add_cross_attention=add_cross, attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0,
        attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def make_cfgs(use_cross, **kw):
    base = dict(vocab_size=VOCAB, n_positions=POS, n_embd=EMBD, n_layer=LAYER, n_head=HEAD,
                use_cross_attention=use_cross, dtype="float32", embd_pdrop=0.0,
                attn_pdrop=0.0, resid_pdrop=0.0, **kw)
    return JaxConfig(**base), ModelConfig(**base)


def _state_with_head(hf):
    """HF's state dict plus an emotion head, as the reference's model has."""
    emo = torch.randn(7, EMBD, generator=torch.Generator().manual_seed(3)) * 0.02
    return dict(hf.state_dict(), **{"emotion_head.weight": emo}), emo


def _inputs(use_cross):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, (2, 10))
    labels = ids.copy()
    labels[:, :4] = -100
    kw = dict(ids=ids, labels=labels, emo=np.array([2, 6]))
    if use_cross:
        kw["enc"] = rng.standard_normal((2, 6, EMBD)).astype(np.float32)
        kw["enc_mask"] = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], np.float32)
    return kw


@pytest.mark.parametrize("use_cross", [False, True])
def test_logits_emotion_and_loss_match_hf_and_jax(use_cross):
    hf = make_hf(use_cross)
    jc, tc = make_cfgs(use_cross)
    sd, emo_w = _state_with_head(hf)
    x = _inputs(use_cross)
    enc = {} if not use_cross else dict(encoder_hidden_states=x["enc"],
                                        encoder_attention_mask=x["enc_mask"])

    with torch.no_grad():
        tkw = {k: T(v) for k, v in enc.items()}
        ref = hf(input_ids=T(x["ids"]), **tkw)
        h = hf.transformer(input_ids=T(x["ids"]), **tkw).last_hidden_state
        ref_emo = h[:, -1] @ emo_w.T
        ref_loss = (torch.nn.functional.cross_entropy(
            ref.logits[:, :-1].reshape(-1, VOCAB), T(x["labels"])[:, 1:].reshape(-1))
            + torch.nn.functional.cross_entropy(ref_emo, T(x["emo"])))

    pt = tconv.hf_to_params(sd, tc, device="cpu")
    with torch.inference_mode():
        got = tg.forward(pt, tc, T(x["ids"]), labels=T(x["labels"]), emotion_labels=T(x["emo"]),
                         **tkw)
    jout = jg.forward(jconv.hf_to_params(sd, jc), jc, jnp.asarray(x["ids"]),
                      labels=jnp.asarray(x["labels"]), emotion_labels=jnp.asarray(x["emo"]),
                      **{k: jnp.asarray(v) for k, v in enc.items()})
    for want in (ref.logits.numpy(), np.asarray(jout.logits)):
        np.testing.assert_allclose(got.logits.numpy(), want, atol=TOL, rtol=TOL)
    for want in (ref_emo.numpy(), np.asarray(jout.emotion_logits)):
        np.testing.assert_allclose(got.emotion_logits.numpy(), want, atol=TOL, rtol=0)
    for want in (float(ref_loss), float(jout.loss)):
        np.testing.assert_allclose(float(got.loss), want, rtol=TOL)


def test_state_dict_round_trips():
    """The port's export is JAX's export of the same weights, HF loads it
    and computes the port's logits, and converting it back gives the
    same model."""
    jc, tc = make_cfgs(True, modality_dim=48)
    tree = jax.tree_util.tree_map(np.asarray, jg.init_params(jax.random.PRNGKey(0), jc))
    pt = tconv.params_from_numpy(tree, tc, device="cpu")
    sd = tconv.params_to_hf(pt, tc)
    want = jconv.params_to_hf(tree, jc)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)

    back = tconv.hf_to_params(sd, tc, device="cpu")
    for (k, a), (k2, b) in zip(pt.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k

    hf = make_hf(True)
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not missing and set(unexpected) == {"emotion_head.weight", "img_proj.weight",
                                               "img_proj.bias", "aud_proj.weight", "aud_proj.bias"}
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 9))
    enc = torch.randn(2, 5, EMBD, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        ref = hf(input_ids=T(ids), encoder_hidden_states=enc).logits
        got = tg.forward(pt, tc, T(ids), encoder_hidden_states=enc).logits
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=TOL)


def test_load_torch_checkpoint_and_geometry(tmp_path):
    hf = make_hf(True)
    sd, _ = _state_with_head(hf)
    path = tmp_path / "model.ckpt"
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    _, tc = make_cfgs(True)
    got = tconv.load_torch_checkpoint(str(path), tc, device="cpu")
    want = tconv.hf_to_params(sd, tc, device="cpu")
    for (k, a), (_, b) in zip(got.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k
    assert tconv.infer_geometry(sd) == jconv.infer_geometry(sd) == {
        "n_layer": LAYER, "n_embd": EMBD, "n_positions": POS, "vocab_size": VOCAB}


def test_pretrained_gpt2_gets_fresh_cross_attention_and_head():
    """A checkpoint without cross-attention and emotion head (pretrained
    GPT-2) converts into a cross-attention config: the missing parts come
    from the generator, deterministically, the rest from the checkpoint;
    a missing core tensor is refused."""
    hf = make_hf(False)
    _, tc = make_cfgs(True)
    a = tconv.hf_to_params(hf.state_dict(), tc, generator=torch.Generator().manual_seed(5),
                           device="cpu")
    b = tconv.hf_to_params(hf.state_dict(), tc, generator=torch.Generator().manual_seed(5),
                           device="cpu")
    assert torch.equal(a.blocks[0].cross_attn.q_attn.kernel, b.blocks[0].cross_attn.q_attn.kernel)
    assert torch.equal(a.emotion_head.kernel, b.emotion_head.kernel)
    assert torch.equal(a.blocks[1].attn.c_attn.kernel,
                       hf.state_dict()["transformer.h.1.attn.c_attn.weight"])
    bad = {k: v for k, v in hf.state_dict().items() if "h.1.mlp.c_fc.weight" not in k}
    with pytest.raises(KeyError, match="c_fc"):
        tconv.hf_to_params(bad, tc, device="cpu")


def test_pruned_model_matches_jax_and_hf():
    hf = make_hf(False)
    jc, tc = make_cfgs(False)
    to_prune = {0: [1], 1: [2]}
    pj, pjc = jg.prune_heads(jconv.hf_to_params(hf.state_dict(), jc), jc, to_prune)
    pt, ptc = tg.prune_heads(tconv.hf_to_params(hf.state_dict(), tc, device="cpu"), tc, to_prune)
    assert (ptc.n_head, ptc.head_dim, ptc.inner_dim) == (pjc.n_head, pjc.head_dim,
                                                         pjc.inner_dim) == (HEAD - 1, 8, 128)
    hf.transformer._prune_heads(to_prune)
    ids = np.random.default_rng(0).integers(0, VOCAB, (2, 10))
    with torch.inference_mode():
        got = tg.forward(pt, ptc, T(ids)).logits.numpy()
        ref = hf(input_ids=T(ids)).logits.numpy()
    for want in (ref, np.asarray(jg.forward(pj, pjc, jnp.asarray(ids)).logits)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError):
        tg.prune_heads(pt, ptc, {0: [1], 1: [0, 2]})


def test_resized_model_matches_jax():
    """New rows: N(0, initializer_range) from the generator (the RNG
    streams differ from JAX's, so the rows are held to their statistics
    and to the generator's repeat); the old rows and every logit over the
    old vocabulary equal JAX's resized model's."""
    jc, tc = make_cfgs(False)
    tree = jax.tree_util.tree_map(np.asarray, jg.init_params(jax.random.PRNGKey(1), jc))
    new = VOCAB + 64
    pj = jg.resize_token_embeddings(tree, jax.random.PRNGKey(9), new, jc)
    runs = [tg.resize_token_embeddings(tconv.params_from_numpy(tree, tc, device="cpu"),
                                       torch.Generator().manual_seed(9), new, tc)
            for _ in range(2)]
    pt = runs[0]
    wte = pt.wte.embedding.detach()
    assert wte.shape == (new, EMBD) and pt.config.vocab_size == new
    assert torch.equal(wte, runs[1].wte.embedding)
    np.testing.assert_array_equal(wte[:VOCAB].numpy(), tree["wte"]["embedding"])
    extra = wte[VOCAB:]
    assert abs(float(extra.std()) / tc.initializer_range - 1) < 0.1
    assert abs(float(extra.mean())) < 2e-3
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, 8))
    with torch.inference_mode():
        got = tg.forward(pt, tc.replace(vocab_size=new), T(ids)).logits.numpy()
    want = np.asarray(jg.forward(pj, jc.replace(vocab_size=new), jnp.asarray(ids)).logits)
    np.testing.assert_allclose(got[..., :VOCAB], want[..., :VOCAB], atol=1e-5, rtol=0)

    hf = make_hf(False)
    grown = tconv.hf_to_params(hf.state_dict(), tc.replace(vocab_size=VOCAB + 3), device="cpu")
    assert grown.wte.embedding.shape[0] == VOCAB + 3
    assert torch.equal(grown.wte.embedding[:VOCAB], hf.state_dict()["transformer.wte.weight"])
