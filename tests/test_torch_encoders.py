"""Port parity: the audio and vision encoders, ``extract_features`` and
``text_features`` of ergm_tpu_torch against ergm_tpu (and HF's torch
models, built locally with random weights, no downloads).

Tiny geometries as in tests/test_modality_encoders.py: audio with 2 conv
layers and width 32, vision at 32 px with patch 8. The same numpy
weights go through both packages' converters. Bars: the encoders,
log-mel and text features within 1e-4 of JAX in fp32; HF within 2e-3
(PARITY.md:22). ``resample`` is held to JAX's float32 positions to one
ulp: XLA's CPU division is not correctly rounded, so ``jnp.linspace``'s
quotients differ from the port's correctly rounded ones by up to one
float32 ulp, and each sample by that ulp times the local slope.
"""
import functools
import os
import pickle
import sys
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ergm_tpu.core.config import ModelConfig as JaxConfig
from ergm_tpu.models import gpt2 as jg
from ergm_tpu.tools import audio as ja
from ergm_tpu.tools import extract_features as jx
from ergm_tpu.tools import text_features as jt
from ergm_tpu.tools import vision as jv
from ergm_tpu_torch.core.config import ModelConfig
from ergm_tpu_torch.models.convert import (audio_params_from_numpy, params_from_numpy,
                                           vision_params_from_numpy)
from ergm_tpu_torch.tools import audio as ta
from ergm_tpu_torch.tools import extract_features as tx
from ergm_tpu_torch.tools import text_features as tt
from ergm_tpu_torch.tools import vision as tv
from ergm_tpu_torch.utils.torch_io import load_torch_state

torch.set_num_threads(1)
TOL, HF_TOL = 1e-4, 2e-3
AUDIO = dict(conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=32,
             num_layers=2, num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
VISION = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64)


def _noisy(tree, seed):
    """JAX's init plus noise, so that biases and norms are not trivial."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def audio_models():
    jc, tc = ja.AudioEncoderConfig(**AUDIO), ta.AudioEncoderConfig(**AUDIO)
    tree = _noisy(ja.init_audio_params(jax.random.PRNGKey(0), jc), 0)
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    return jc, tc, pj, audio_params_from_numpy(tree, tc, device="cpu")


@pytest.fixture(scope="module")
def vision_models():
    jc, tc = jv.VisionEncoderConfig(**VISION), tv.VisionEncoderConfig(**VISION)
    tree = _noisy(jv.init_vision_params(jax.random.PRNGKey(1), jc), 1)
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    return jc, tc, pj, vision_params_from_numpy(tree, tc, device="cpu")


@pytest.mark.parametrize("fn", ["audio_encoder", "extract_audio_features"])
def test_audio_encoder_matches_jax(audio_models, fn):
    jc, tc, pj, pt = audio_models
    wav = np.random.default_rng(2).standard_normal((2, 1600)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(getattr(ja, fn), cfg=jc))(pj, wav=wav))
    with torch.inference_mode():
        got = getattr(ta, fn)(pt, tc, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if fn == "audio_encoder":
        assert got.shape[1] == tc.frames_for_samples(1600)


@pytest.mark.parametrize("fn", ["vision_encoder", "extract_image_features"])
def test_vision_encoder_matches_jax(vision_models, fn):
    jc, tc, pj, pt = vision_models
    img = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(getattr(jv, fn), cfg=jc))(pj, images=img))
    with torch.inference_mode():
        got = getattr(tv, fn)(pt, tc, torch.from_numpy(img)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _tone(n, sr, seed=0):
    """Two tones and a little noise: a smooth, speech-band signal."""
    t = np.arange(n) / sr
    noise = np.random.default_rng(seed).standard_normal(n)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1330 * t)
            + 0.02 * noise).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out,n", [(22050, 16000, 22050), (8000, 16000, 4001),
                                            (16000, 16000, 1000)])
def test_resample_matches_jax(sr_in, sr_out, n):
    wav = _tone(n, sr_in)
    want = np.asarray(ja.resample(jnp.asarray(wav), sr_in, sr_out))
    got = ta.resample(torch.from_numpy(wav), sr_in, sr_out).numpy()
    assert got.shape == want.shape
    if sr_in == sr_out:
        np.testing.assert_array_equal(got, want)
        return
    pos_j = np.asarray(jnp.linspace(0.0, n - 1.0, len(want)))
    pos_t = np.linspace(0.0, n - 1.0, len(want)).astype(np.float32)
    ulp = np.spacing(np.float32(n - 1))
    assert np.abs(pos_j - pos_t).max() <= ulp
    i0 = np.clip(np.floor(pos_t).astype(int), 0, n - 1)
    slope = np.maximum(np.abs(wav[np.clip(i0 + 1, 0, n - 1)] - wav[i0]),
                       np.abs(wav[i0] - wav[np.clip(i0 - 1, 0, n - 1)]))
    assert np.all(np.abs(got - want) <= ulp * slope + 1e-6)


def test_log_mel_and_filterbank_match_jax():
    np.testing.assert_array_equal(ta.mel_filterbank(80, 400, 16000),
                                  ja.mel_filterbank(80, 400, 16000))
    np.testing.assert_array_equal(ta.mel_filterbank(40, 512, 22050, fmin=50.0, fmax=8000.0),
                                  ja.mel_filterbank(40, 512, 22050, fmin=50.0, fmax=8000.0))
    wav = np.stack([_tone(8000, 16000, 0), np.random.default_rng(4).standard_normal(8000)
                    .astype(np.float32)])
    want = np.asarray(ja.log_mel_spectrogram(jnp.asarray(wav)))
    got = ta.log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    # a log-mel error is the bin energy's relative error; the FFTs' float32
    # rounding is relative to the frame's energy, so a bin far below its
    # frame's peak (the tone's: ~1e-7 of it) reads it magnified. Bins at
    # 1e-4 of the peak or more hold 1e-4; every bin holds 2e-3 (1.1e-3
    # measured, at a bin 3e-7 of its peak).
    strong = want >= want.max(axis=-1, keepdims=True) + np.log(1e-4)
    assert strong.mean() > 0.5
    np.testing.assert_allclose(got[strong], want[strong], atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=0)


def test_fp32_convolutions_restores_the_setting():
    saved = torch.backends.cudnn.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            with ta.fp32_convolutions():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_safetensors_dir_without_the_package_raises(tmp_path, monkeypatch):
    (tmp_path / "model.safetensors").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors"):
        load_torch_state(str(tmp_path))


# -- HF's models, random weights built locally ------------------------------


@pytest.fixture(scope="module")
def hf_audio():
    """A tiny HF Wav2Vec2Model (importing its module takes ~10 s here)."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, vocab_size=32, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, activation_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2Model(cfg).eval()
    with torch.no_grad():  # non-trivial norms and biases
        for name, p in hf.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.05 * torch.randn(p.shape))
    return hf


@pytest.fixture(scope="module")
def hf_vision():
    transformers = pytest.importorskip("transformers")
    from transformers.models.blip.modeling_blip import BlipVisionModel

    cfg = transformers.BlipVisionConfig(hidden_size=32, num_hidden_layers=2,
                                        num_attention_heads=4, intermediate_size=64,
                                        image_size=32, patch_size=8, attention_dropout=0.0)
    torch.manual_seed(1)
    return BlipVisionModel(cfg).eval()


def _old_weight_norm_names(state):
    """The same state dict under torch's older weight_norm names."""
    ren = {"parametrizations.weight.original0": "weight_g",
           "parametrizations.weight.original1": "weight_v"}
    out = {}
    for k, v in state.items():
        for new, old in ren.items():
            k = k.replace(new, old)
        out[k] = v
    return out


@pytest.mark.parametrize("names", ["parametrizations", "weight_g"])
def test_audio_matches_hf(hf_audio, names):
    hf = hf_audio
    state = hf.state_dict()
    if names == "weight_g":
        state = _old_weight_norm_names(state)
        assert any(k.endswith("weight_g") for k in state)
    cfg = ta.AudioEncoderConfig(**AUDIO)
    pt = ta.hf_to_audio_params(state, cfg, device="cpu")
    wav = np.random.default_rng(5).standard_normal((2, 1200)).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(wav)).last_hidden_state.numpy()
        got = ta.audio_encoder(pt, cfg, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=0)
    # the conversion itself is JAX's, array for array
    jtree = ja.hf_to_audio_params(state, ja.AudioEncoderConfig(**AUDIO))
    ttree = ta.hf_to_audio_tree(state, cfg)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                            jax.tree_util.tree_leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_vision_matches_hf(hf_vision):
    hf = hf_vision
    cfg = tv.VisionEncoderConfig(**VISION)
    pt = tv.hf_to_vision_params(hf.state_dict(), cfg, device="cpu")
    img = np.random.default_rng(6).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(img)).last_hidden_state.numpy()
        got = tv.vision_encoder(pt, cfg, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=0)


# -- extract_features.main ---------------------------------------------------


def _write_wav(path, x, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def test_extract_features_main_matches_jax(tmp_path, monkeypatch, hf_audio, hf_vision):
    """Both CLIs over one clips directory (16 kHz and 22.05 kHz WAVs, PNG
    keyframes where PIL is present), with tiny local HF checkpoints."""
    w2v, blip = tmp_path / "w2v", tmp_path / "blip"
    for d, model in ((w2v, hf_audio), (blip, hf_vision)):
        d.mkdir()
        torch.save(model.state_dict(), d / "pytorch_model.bin")
    for mod, cfg in ((ja, AUDIO), (ta, AUDIO), (jv, VISION), (tv, VISION)):
        name = "AudioEncoderConfig" if mod in (ja, ta) else "VisionEncoderConfig"
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **cfg))
    try:
        from PIL import Image
    except ImportError:
        Image = None
    clips = tmp_path / "clips"
    rng = np.random.default_rng(7)
    for di, (n16, n22) in enumerate(((1600, 2205), (2400, 3100))):
        d = clips / f"dia{di}"
        d.mkdir(parents=True)
        _write_wav(d / "u0.wav", _tone(n16, 16000, di), 16000)
        _write_wav(d / "u1.wav", _tone(n22, 22050, di + 5), 22050)
        if Image is not None:
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(d / "k0.png")
    out_j, out_t = tmp_path / "j.pkl", tmp_path / "t.pkl"
    common = [f"--clips_dir={clips}", "--split=test", f"--wav2vec2_dir={w2v}",
              f"--blip_dir={blip}"]
    jx.main(common + [f"--output_file={out_j}"])
    tx.main(common + [f"--output_file={out_t}", "--device=cpu"])
    with open(out_j, "rb") as f:
        want = pickle.load(f)["test"]
    with open(out_t, "rb") as f:
        got = pickle.load(f)["test"]
    for kind in ("aud", "img"):
        assert [len(x) for x in got[kind]] == [len(x) for x in want[kind]]
        for g_dia, w_dia in zip(got[kind], want[kind]):
            for g, w in zip(g_dia, w_dia):
                assert g.dtype == np.float32 and g.shape == (32,)
                np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)
    assert len(got["aud"][0]) == 2 and len(got["img"][0]) == (1 if Image is not None else 0)


# -- text_features -----------------------------------------------------------

TEXT = dict(n_layer=2, n_embd=32, n_head=2, vocab_size=128, n_positions=192, dtype="float32",
            use_cross_attention=False)


def test_text_features_match_jax():
    jc, tc = JaxConfig(**TEXT), ModelConfig(**TEXT)
    tree = _noisy(jg.init_params(jax.random.PRNGKey(2), jc), 2)
    rng = np.random.default_rng(8)
    utts = [rng.integers(0, 128, int(n)).tolist() for n in rng.integers(1, 150, 21)]
    want = jt.extract_text_features(jax.tree_util.tree_map(jnp.asarray, tree), jc, utts,
                                    batch_size=8)
    got = tt.extract_text_features(params_from_numpy(tree, tc, device="cpu"), tc, utts,
                                   batch_size=8)
    assert len(got) == len(want) == 21
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (32,)
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)


def test_new_modules_import_no_jax():
    """Every module this slice adds imports without JAX (checked in a
    fresh interpreter: this process has JAX loaded by the test setup)."""
    import subprocess

    mods = ["utils.torch_io", "tools.audio", "tools.vision", "tools.extract_features",
            "tools.text_features", "tools.text2ids", "tokenizer.bpe", "tokenizer.native",
            "evaluation.evaluate", "evaluation.bertscore", "infer.runner", "infer.interact",
            "models.convert"]
    code = ("import sys; " + "; ".join(f"import ergm_tpu_torch.{m}" for m in mods) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ergm_tpu')]; "
            "assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
