"""The port's data tools against ergm_tpu's on the fixtures of
tests/test_{labels_csv,labels_iemocap,tools}.py: MELD labels (the port
reads the CSV with the ``csv`` module, JAX with pandas), the generic CSV
converter and the IEMOCAP converter write byte-equal pickles and JSON;
the corpus loaders give equal dialogues; errors are the same. Then the
worker loader (``data/loader.py``): every example once, deterministic
per seed, and the batches of ``dataset.batches`` at 0 and 2 workers.
"""
import os
import pickle

import numpy as np
import pytest

from ergm_tpu.tokenizer.bpe import train_bpe as jax_train_bpe
from ergm_tpu.tools import corpora as jax_corpora
from ergm_tpu.tools import labels as jax_labels
from ergm_tpu.tools import labels_csv as jax_labels_csv
from ergm_tpu.tools import labels_iemocap as jax_iemocap
from ergm_tpu_torch.data.dataset import DialogueDataset, batches
from ergm_tpu_torch.data.loader import close, make_loader
from ergm_tpu_torch.data.synthetic import write_synthetic_dataset
from ergm_tpu_torch.tokenizer.bpe import train_bpe as port_train_bpe
from ergm_tpu_torch.tools import corpora as port_corpora
from ergm_tpu_torch.tools import labels as port_labels
from ergm_tpu_torch.tools import labels_csv as port_labels_csv
from ergm_tpu_torch.tools import labels_iemocap as port_iemocap

from test_labels_csv import HEADER, LABEL_MAP, medic_rows, write_csv
from test_labels_iemocap import EMO_FILE, TRANS_FILE


def _same_outputs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _both(tmp_path, jax_main, port_main, argv):
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        (tmp_path / pkg).mkdir()
        main([a.replace("{out}", str(tmp_path / pkg)) for a in argv])
    _same_outputs(tmp_path / "jax", tmp_path / "port")


def test_meld_labels_equal_jax(tmp_path):
    """train/dev/test CSVs with quoted commas, non-contiguous dialogue ids
    and padded labels: the same pickle bytes as JAX's pandas reader."""
    src = tmp_path / "meld"
    src.mkdir()
    rows = [("0", '"Oh, really?"', " Joy", "positive"), ("0", "No.", "neutral ", "neutral"),
            ("3", "Hey", "anger", "negative"), ("1", "Sure", "SADNESS", "negative"),
            ("3", "Fine", "surprise", "positive")]
    for split in ("train", "dev"):
        with open(src / f"{split}_sent_emo.csv", "w") as f:
            f.write("Sr No.,Utterance,Emotion,Sentiment,Dialogue_ID\n")
            for i, (d, u, e, s) in enumerate(rows):
                f.write(f"{i},{u},{e},{s},{d}\n")
    _both(tmp_path, jax_labels.main, port_labels.main,
          [f"--data_dir={src}", "--output_file={out}/labels.pkl"])
    got = pickle.load(open(tmp_path / "port" / "labels.pkl", "rb"))
    assert set(got) == {"train", "dev"}
    assert got["train"]["emotion"] == port_labels.labels_from_rows(
        ["0", "0", "3", "1", "3"], ["joy", "neutral", "anger", "sadness", "surprise"],
        ["positive"] * 5)["emotion"]


def _medic_csv(tmp_path, rows=None, header=HEADER, name="medic.csv"):
    csv = tmp_path / name
    write_csv(csv, rows or medic_rows(), header)
    return csv


@pytest.mark.parametrize("case", ["mapped", "drop", "split_col", "fraction", "per_split"])
def test_labels_csv_equal_jax(tmp_path, case):
    base = ["--dialogue_col=session_id", "--utterance_col=text",
            "--emotion_col=empathy_label", f"--label_map={LABEL_MAP}", "--output_dir={out}"]
    if case == "mapped":
        argv = [f"--csv={_medic_csv(tmp_path)}", "--order_col=turn", "--train_frac=1.0", *base]
    elif case == "drop":
        rows = medic_rows()
        rows[2]["empathy_label"] = "mystery"
        argv = [f"--csv={_medic_csv(tmp_path, rows)}", "--order_col=turn",
                "--train_frac=1.0", "--unmapped=drop", *base]
    elif case == "split_col":
        rows = [dict(session_id="a", turn=0, text="x", empathy_label="no_empathy",
                     split="train", senti="negative"),
                dict(session_id="b", turn=0, text="y", empathy_label="no_empathy",
                     split="test", senti="positive")]
        csv = _medic_csv(tmp_path, rows, HEADER + ["split", "senti"])
        argv = [f"--csv={csv}", "--sentiment_col=senti", "--split_col=split", *base]
    elif case == "fraction":
        rows = [dict(session_id=f"d{d}", turn=t, text=f"u{d}-{t}", empathy_label="no_empathy")
                for d in range(20) for t in range(3)]
        argv = [f"--csv={_medic_csv(tmp_path, rows)}", "--train_frac=0.8", "--seed=7", *base]
    else:
        rows = [dict(Dialogue_ID=0, Utterance="hi", Emotion="joy"),
                dict(Dialogue_ID=0, Utterance="yo", Emotion="anger")]
        csv = _medic_csv(tmp_path, rows, ["Dialogue_ID", "Utterance", "Emotion"], "train.csv")
        argv = [f"--train_csv={csv}", "--output_dir={out}"]
    _both(tmp_path, jax_labels_csv.main, port_labels_csv.main, argv)


def test_labels_csv_errors_equal_jax(tmp_path):
    rows = medic_rows()
    rows[0]["empathy_label"] = "mystery"
    csv = _medic_csv(tmp_path, rows)
    for main in (jax_labels_csv.main, port_labels_csv.main):
        with pytest.raises(ValueError, match="mystery"):
            main([f"--csv={csv}", "--dialogue_col=session_id", "--utterance_col=text",
                  "--emotion_col=empathy_label", f"--label_map={LABEL_MAP}",
                  "--train_frac=1.0", f"--output_dir={tmp_path / 'o'}"])
        with pytest.raises(ValueError, match="canonical"):
            main([f"--csv={csv}", "--label_map=a=notanemotion", "--train_frac=1.0",
                  f"--output_dir={tmp_path / 'o'}"])


@pytest.fixture()
def release(tmp_path):
    for s in (1, 4, 5):
        d = tmp_path / "release" / f"Session{s}" / "dialog"
        (d / "EmoEvaluation").mkdir(parents=True)
        (d / "transcriptions").mkdir(parents=True)
        (d / "EmoEvaluation" / f"Ses0{s}F_impro01.txt").write_text(EMO_FILE.format(s=s))
        (d / "transcriptions" / f"Ses0{s}F_impro01.txt").write_text(TRANS_FILE.format(s=s))
    return tmp_path / "release"


@pytest.mark.parametrize("extra", [[], ["--drop_unmapped"], ["--valid_session=1",
                                                             "--test_session=4"]])
def test_iemocap_equal_jax(release, tmp_path, extra):
    _both(tmp_path, jax_iemocap.main, port_iemocap.main,
          [f"--data_dir={release}", "--output_dir={out}", *extra])


def test_iemocap_errors_equal_jax(release, tmp_path):
    for mod in (jax_iemocap, port_iemocap):
        with pytest.raises(ValueError, match="distinct sessions"):
            mod.convert(str(release), valid_session=5, test_session=5)
        with pytest.raises(FileNotFoundError, match="EmoEvaluation"):
            mod.convert(str(tmp_path / "nowhere"))
        assert mod.session_of("Ses03F_impro05") == 3 and mod.session_of("garbage") is None


@pytest.fixture(scope="module")
def bpes():
    corpus = ["hello there how are you doing today my friend"] * 3
    return jax_train_bpe(corpus, vocab_size=320), port_train_bpe(corpus, vocab_size=320)


def test_corpora_equal_jax(bpes):
    """The four loaders on injected rows (no download) and the
    detokenizer cleanup give JAX's dialogues."""
    daily = [["hello there", "how are you"], ["doing today", "my friend"],
             ["hello hello", "you you’re"], ["today today", "friend friend"]]
    emp = {"utterance": ["hello there", "how are you", "doing today_comma_ friend",
                         "skip me_conv", "you you"],
           "conv_id": ["a", "a", "a", "a", "b"], "speaker_idx": [1, 1, 2, 2, 3]}
    persona = [{"utterances": [{"history": ["ignored"]},
                               {"history": ["hello there", "__ SILENCE __", "how are you"]}]}]
    blended = {"previous_utterance": [["seed one", "seed two"]],
               "free_messages": [["hello there", "how are you"]],
               "guided_messages": [["doing today"]]}
    for name, data, frac in (("load_daily", daily, 0.5), ("load_empathetic", emp, 1.0),
                             ("load_persona", persona, 1.0), ("load_blended", blended, 1.0)):
        want = getattr(jax_corpora, name)(bpes[0], frac, data=data)
        got = getattr(port_corpora, name)(bpes[1], frac, data=data)
        assert got == want, name
    for toks in (["yes", ".", "Ġnow", "Ġgo"], ["Ġ'", "s", "Ġ\"", "hi", "Ġ\""], []):
        assert port_corpora.clean_token_list(toks) == jax_corpora.clean_token_list(toks)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("loader"))
    st = write_synthetic_dataset(d, prefixes=("train",), num_dialogues=10,
                                 turns_per_dialogue=3, utter_len=range(3, 30), seed=0)
    return DialogueDataset("train", d, sp1_id=st.sp1_id, sp2_id=st.sp2_id, eos_id=st.eos_id,
                           max_len=256), st


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_the_plain_iterator(dataset, workers):
    """Shuffled, length-grouped, pad multiple 64, the partial batch dropped:
    the loader's batches are ``batches()``'s, at 0 and 2 workers."""
    ds, st = dataset
    kw = dict(shuffle=True, seed=5, pad_multiple=64, max_len=256, drop_remainder=True,
              length_grouped=2)
    want = list(batches(ds, 4, st.eos_id, **kw))
    got = list(make_loader(ds, batch_size=4, eos_id=st.eos_id, num_workers=workers, **kw))
    assert len(got) == len(want) == len(ds) // 4
    for a, b in zip(got, want):
        for f in ("input_ids", "token_type_ids", "labels", "imgs", "auds", "emotion_labels",
                  "attention_mask", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)



def test_close_stops_the_workers_and_the_next_epoch_starts_them_again(dataset):
    """``close`` ends the loader's worker processes at once (the Trainer's
    workers end with ``train``); the next epoch starts new ones and reads
    the same batches."""
    ds, st = dataset
    loader = make_loader(ds, batch_size=4, eos_id=st.eos_id, shuffle=True, seed=3,
                         max_len=256, num_workers=2)
    first = [b.input_ids.tolist() for b in loader]
    workers = [w for w in loader._iterator._workers]
    assert len(workers) == 2 and all(w.is_alive() for w in workers)
    close(loader)
    assert loader._iterator is None and not any(w.is_alive() for w in workers)
    assert [b.input_ids.tolist() for b in loader] == first
    close(loader)
    close(loader)  # nothing left to stop
    close(make_loader(ds, batch_size=4, eos_id=st.eos_id, max_len=256))  # no workers

def test_loader_covers_every_example_and_is_deterministic(dataset):
    ds, st = dataset
    kw = dict(batch_size=4, eos_id=st.eos_id, max_len=256)
    seen = [tuple(r[:int(m.sum())].tolist()) for b in make_loader(ds, **kw)
            for r, m, v in zip(b.input_ids, b.attention_mask, b.valid) if v]
    assert sorted(seen) == sorted(tuple(e.input_ids) for e in ds.examples)

    def order(seed):
        return [b.input_ids.tolist() for b in make_loader(ds, shuffle=True, seed=seed, **kw)]
    assert order(1) == order(1) != order(2)
    # two hosts: disjoint shards of equal length (dataset.host_shard_order)
    hosts = [[tuple(r[:int(m.sum())].tolist()) for b in make_loader(
        ds, host_index=h, host_count=2, drop_remainder=True, **kw)
        for r, m in zip(b.input_ids, b.attention_mask)] for h in (0, 1)]
    assert len(hosts[0]) == len(hosts[1]) == len(ds) // 2 // 4 * 4
    assert not set(hosts[0]) & set(hosts[1])
