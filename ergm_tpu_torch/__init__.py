"""ERGM in PyTorch and CUDA: the port of ``ergm_tpu`` to an NVIDIA H100.

The package mirrors ``ergm_tpu``'s module paths and function names.
Plain tensor code is PyTorch and runs on the CPU too; every Pallas
kernel of ``ergm_tpu`` on a ported path becomes a kernel written by
hand for Hopper (``csrc/``), built at first use. The package never
imports JAX.

Beside the model (``models/``), generation, beam search, speculative
decoding, the continuous-batching server and its HTTP front end
(``infer/``) and training (``train/``), it carries the paths from a
dataset's media to reported numbers: the wav2vec2 and BLIP-ViT encoders
and the feature-extraction CLI (``tools/audio.py``, ``tools/vision.py``,
``tools/extract_features.py``), mean-pooled text features
(``tools/text_features.py``), the byte-level BPE tokenizer with its
native merge loop (``tokenizer/``, ``tools/text2ids.py``), the metrics
(``evaluation/``), the dataset runner and the REPL (``infer/runner.py``,
``infer/interact.py``), and HF checkpoint loading
(``utils/torch_io.py``).
"""

__version__ = "0.1.0"

from ergm_tpu_torch.core.config import ModelConfig  # noqa: F401
