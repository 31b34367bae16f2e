"""Feature-extraction CLI: media files -> per-dialogue feature pickles
(counterpart of ``ergm_tpu/tools/extract_features.py``).

Runs the port's audio and vision encoders (``tools/audio.py``,
``tools/vision.py``) over utterance clips and keyframes on the card (or
the device given), one file at a time at B=1 as JAX runs one program per
file, mean-pools, and writes ``{split: {"img": [...], "aud": [...]}}``
pickles in the layout ``cli/load_data.py`` consumes.

Pretrained weights come from LOCAL HF checkpoint dirs, never a download:
``--wav2vec2_dir`` / ``--blip_dir`` point at directories holding
pytorch_model.bin or model.safetensors for facebook/wav2vec2-base-960h /
Salesforce/blip-image-captioning-base. Audio files must be WAV (stdlib
``wave`` reads them; resampling runs on the device). Images load through
PIL, which the image loader imports when it first reads an image.

Usage::

    python -m ergm_tpu_torch.tools.extract_features --clips_dir=CLIPS \\
        --output_file=features.pkl --split=train [--wav2vec2_dir=DIR] [--blip_dir=DIR]
"""

from __future__ import annotations

import argparse
import os
import pickle
import wave
from typing import Dict, List, Optional

import numpy as np
import torch

from ergm_tpu_torch.core.device import resolve

# the ImageNet/CLIP normalisation of ergm_tpu/tools/extract_features.py:96-97
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_wav(path: str) -> tuple:
    """(samples float32 [-1,1] mono, sample_rate) from a PCM WAV."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def _load_torch_state(model_dir: str):
    from ergm_tpu_torch.utils.torch_io import load_torch_state

    return load_torch_state(model_dir)


def build_audio_extractor(wav2vec2_dir: Optional[str], device="cuda"):
    """``extract(path) -> [768] float32`` through the wav2vec2-base encoder
    on ``device`` (the card unless the caller asks for the CPU). Without a
    checkpoint dir the weights are random, drawn from a CPU generator
    seeded with 0, so every device gets the same ones."""
    from ergm_tpu_torch.tools.audio import (AudioEncoderConfig, extract_audio_features,
                                            hf_to_audio_params, init_audio_params, resample)

    device = resolve(device)
    cfg = AudioEncoderConfig()
    if wav2vec2_dir:
        params = hf_to_audio_params(_load_torch_state(wav2vec2_dir), cfg, device=device)
    else:
        print("WARNING: no --wav2vec2_dir; using random-init audio encoder")
        params = init_audio_params(torch.Generator().manual_seed(0), cfg, device=device)

    @torch.inference_mode()
    def extract(path: str) -> np.ndarray:
        x, sr = load_wav(path)
        wav = torch.as_tensor(x, device=device)
        if sr != 16000:
            wav = resample(wav, sr, 16000)
        return extract_audio_features(params, cfg, wav[None])[0].cpu().numpy()

    return extract


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8-range floats -> [3, H, W] normalised pixel values."""
    arr = arr.astype(np.float32) / 255.0
    return ((arr - IMAGE_MEAN) / IMAGE_STD).transpose(2, 0, 1)


def build_image_extractor(blip_dir: Optional[str], device="cuda"):
    """``extract(path) -> [768] float32`` through the BLIP ViT-B/16 encoder
    at 384 px on ``device`` (random weights from a CPU generator seeded
    with 1 without a checkpoint dir)."""
    from ergm_tpu_torch.tools.vision import (VisionEncoderConfig, extract_image_features,
                                             hf_to_vision_params, init_vision_params)

    device = resolve(device)
    cfg = VisionEncoderConfig()
    if blip_dir:
        params = hf_to_vision_params(_load_torch_state(blip_dir), cfg, device=device)
    else:
        print("WARNING: no --blip_dir; using random-init vision encoder")
        params = init_vision_params(torch.Generator().manual_seed(1), cfg, device=device)

    @torch.inference_mode()
    def extract(path: str) -> np.ndarray:
        from PIL import Image

        im = Image.open(path).convert("RGB").resize((cfg.image_size, cfg.image_size))
        img = torch.as_tensor(normalize_image(np.asarray(im, np.float32)), device=device)
        return extract_image_features(params, cfg, img[None])[0].cpu().numpy()

    return extract


def main(argv=None):
    p = argparse.ArgumentParser(description="Extract audio/visual features on device")
    p.add_argument("--clips_dir", type=str, required=True,
                   help="Dir of per-dialogue subdirs holding utterance .wav files "
                        "and keyframe .jpg/.png files.")
    p.add_argument("--output_file", type=str, required=True)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--wav2vec2_dir", type=str, default=None,
                   help="Local HF Wav2Vec2Model checkpoint dir (never downloaded).")
    p.add_argument("--blip_dir", type=str, default=None,
                   help="Local HF BLIP checkpoint dir (never downloaded).")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device the encoders run on (default: the card).")
    args = p.parse_args(argv)

    audio_fn = build_audio_extractor(args.wav2vec2_dir, device=args.device)
    image_fn = build_image_extractor(args.blip_dir, device=args.device)

    img_out: List[List[np.ndarray]] = []
    aud_out: List[List[np.ndarray]] = []
    for dia in sorted(os.listdir(args.clips_dir)):
        dia_dir = os.path.join(args.clips_dir, dia)
        if not os.path.isdir(dia_dir):
            continue
        wavs = sorted(f for f in os.listdir(dia_dir) if f.endswith(".wav"))
        imgs = sorted(f for f in os.listdir(dia_dir)
                      if f.endswith((".jpg", ".jpeg", ".png")))
        aud_out.append([audio_fn(os.path.join(dia_dir, f)) for f in wavs])
        img_out.append([image_fn(os.path.join(dia_dir, f)) for f in imgs])
        print(f"{dia}: {len(wavs)} wavs, {len(imgs)} images")

    payload: Dict[str, dict] = {args.split: {"img": img_out, "aud": aud_out}}
    if os.path.exists(args.output_file):
        with open(args.output_file, "rb") as f:
            existing = pickle.load(f)
        existing.update(payload)
        payload = existing
    with open(args.output_file, "wb") as f:
        pickle.dump(payload, f)
    print(f"wrote {args.output_file}")


if __name__ == "__main__":
    main()
