"""fairdiff_torch's CLIP tokenizer (its own byte-level BPE, no transformers)
against `transformers.CLIPTokenizer`, which the JAX package loads.

transformers runs here without ftfy, the path the JAX package takes too.
The tokenizer directories are written in `tmp_path` by
`chip_smoke.write_clip_tokenizer` (merges learned from a few prompts, the
published file format); ids, masks and shapes must be equal.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from chip_smoke import SLICE_PROMPTS, write_clip_tokenizer
from fairdiff.io.tokenizer import load_tokenizer as jax_load_tokenizer
from fairdiff.sampling.pipeline import SDConfig as JaxSDConfig
from fairdiff.tools.train_debias import tokenize_prompts as jax_tokenize_prompts
from fairdiff_torch.io.tokenizer import CLIPBPETokenizer, HashTokenizer, load_tokenizer
from fairdiff_torch.sampling.pipeline import SDConfig
from fairdiff_torch.tools import train_debias

torch.set_num_threads(1)

# accents, digits, punctuation, contractions (also upper case), CJK,
# control characters and odd whitespace, letters whose lower case grows,
# compatibility forms, and text over 77 tokens
CORPUS = [
    *SLICE_PROMPTS,
    "a photo of the face of a doctor, a person",
    "Café crème, naïve résumé — ÉCOLE!",
    "it's 1984's best-seller: 42 apples & 7 pears...",
    "北京欢迎你 and 東京 タワー 서울",
    "rock'n'roll ''s 'S 'LL 'Ve they'D",
    "  multiple\tspaces\nnew  lines  nbsp sep\x07bell\x00nul� ",
    "İstanbul ǅemal ＡＢＣ ①②③ ²³ ½",
    "",
    " ".join(["firefighter"] * 90),
    "x" * 300,
]


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    return {
        # merges from a few prompts only: the rest of the corpus stops part-way
        "tiny": write_clip_tokenizer(root / "tiny", CORPUS[:4], vocab_size=None),
        # SD-1.5's shape: 49408 entries, bos 49406, eos 49407 (chip_smoke's)
        "full": write_clip_tokenizer(root / "full", SLICE_PROMPTS),
    }


@pytest.mark.parametrize("which", ["tiny", "full"])
@pytest.mark.parametrize("padding,max_length", [("max_length", None), ("longest", None), ("max_length", 12),
                                                ("longest", 12)])
def test_ids_equal_transformers(tok_dirs, which, padding, max_length):
    from transformers import CLIPTokenizer

    ref = CLIPTokenizer.from_pretrained(str(tok_dirs[which]))
    want = ref(CORPUS, padding="max_length" if padding == "max_length" else True,
               max_length=max_length or ref.model_max_length, truncation=True, return_tensors="np")
    tok = load_tokenizer(tok_dirs[which])
    assert isinstance(tok, CLIPBPETokenizer)
    got = tok(CORPUS, padding=padding, max_length=max_length)
    np.testing.assert_array_equal(got.input_ids, want["input_ids"])
    np.testing.assert_array_equal(got.attention_mask, want["attention_mask"])
    assert got.input_ids.dtype == np.int32
    assert (tok.vocab_size, tok.bos_token_id, tok.eos_token_id, tok.model_max_length) == (
        ref.vocab_size, ref.bos_token_id, ref.eos_token_id, ref.model_max_length)


def test_each_text_alone_equals_transformers(tok_dirs):
    """Word by word: one text a call, so a wrong id names its text."""
    from transformers import CLIPTokenizer

    ref = CLIPTokenizer.from_pretrained(str(tok_dirs["tiny"]))
    tok = load_tokenizer(tok_dirs["tiny"])
    for text in CORPUS:
        assert tok.encode(text) == ref.encode(text, add_special_tokens=False), text


def test_full_vocabulary_layout(tok_dirs):
    tok = load_tokenizer(tok_dirs["full"])
    assert (tok.vocab_size, tok.bos_token_id, tok.eos_token_id) == (49408, 49406, 49407)
    # every slice prompt's words are single tokens (the merges cover them)
    for p in SLICE_PROMPTS:
        assert len(tok.encode(p)) == len(p.replace(",", " ,").split())


def test_unknown_tokens_and_bad_directories(tmp_path, tok_dirs):
    from transformers import CLIPTokenizer

    d = tmp_path / "holes"
    d.mkdir()
    vocab = json.loads((tok_dirs["tiny"] / "vocab.json").read_text())
    merged = [t for t in vocab if len(t) > 5 and not t.startswith("<|")][:3]  # merge results, now unknown
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(t for t in vocab if t not in merged)}))
    (d / "merges.txt").write_text((tok_dirs["tiny"] / "merges.txt").read_text())
    ref = CLIPTokenizer.from_pretrained(str(d))
    tok = load_tokenizer(d)
    np.testing.assert_array_equal(tok(CORPUS[:4]).input_ids,
                                  ref(CORPUS[:4], padding=True, max_length=77, truncation=True,
                                      return_tensors="np")["input_ids"])
    assert tok.model_max_length == 77  # no tokenizer_config.json: CLIP's context
    with pytest.raises(FileNotFoundError, match="does not exist"):
        load_tokenizer(tmp_path / "nowhere")
    (d / "vocab.json").write_text(json.dumps({"a": 0}))
    with pytest.raises(ValueError, match="special tokens"):
        load_tokenizer(d)
    assert isinstance(load_tokenizer(None), HashTokenizer)


def test_overridden_ids_do_not_change_the_output(tok_dirs):
    """train_debias sets the tiny config's ids on the tokenizer; as with the
    JAX package's CLIPTokenizer wrapper, the ids written stay the
    vocabulary's."""
    tok = load_tokenizer(tok_dirs["tiny"])
    before = tok(CORPUS[:3], padding="max_length").input_ids
    tok.bos_token_id, tok.eos_token_id, tok.pad_token_id = 0, 63, 63
    np.testing.assert_array_equal(tok(CORPUS[:3], padding="max_length").input_ids, before)


class _RecordingTrainer:
    """What `train_debias.main` needs of a trainer, recording the prompt ids
    `fit` gets (SD-1.5's text config: 77 positions)."""

    def __init__(self, cfg):
        self.sd = types.SimpleNamespace(config=SDConfig.sd15(), device=torch.device("cpu"))
        self.cfg = train_debias.debias_config(cfg)
        self.fits = []

    def init_state(self, seed):
        return types.SimpleNamespace(step=0, adapters={}, ema={})

    def fit(self, state, train_ids, **kw):
        self.fits.append((train_ids, kw.get("val_prompt_ids")))
        return state


@pytest.mark.parametrize("prompts", [None, ["a photo of the face of a Café owner, a person", "it's 北京"]])
def test_train_debias_tokenizer_dir_matches_jax_cli(tmp_path, tok_dirs, prompts):
    """`--tokenizer_dir` parses, and `main` hands `fit` the ids the JAX CLI
    tokenizes (`load_tokenizer(cfg.tokenizer_dir or None)` then
    `tokenize_prompts`, fairdiff/tools/train_debias.py:202 and :161)."""
    argv = ["--tokenizer_dir", str(tok_dirs["full"]), "--device", "cpu", "--output_dir", str(tmp_path / "out")]
    if prompts:
        (tmp_path / "p.json").write_text(json.dumps({"train_prompts": prompts}))
        argv += ["--prompts_json", str(tmp_path / "p.json")]
    cfg = train_debias.parse_args(argv)
    assert cfg.tokenizer_dir == str(tok_dirs["full"])
    trainer = _RecordingTrainer(cfg)
    train_debias.main(cfg, trainer)
    (train_ids, val_ids), = trainer.fits

    jsd = types.SimpleNamespace(config=JaxSDConfig.sd15())
    jtok = jax_load_tokenizer(cfg.tokenizer_dir or None)
    texts = prompts or list(train_debias.DEFAULT_PROMPTS)
    want = jax_tokenize_prompts(jsd, jtok, texts)
    want_val = jax_tokenize_prompts(jsd, jtok, texts[:4] if prompts else texts[:1])
    for got_list, want_list in ((train_ids, want), (val_ids, want_val)):
        assert len(got_list) == len(want_list)
        for (c, u), (jc, ju) in zip(got_list, want_list):
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    assert train_ids[0][0].shape == (1, 77) and int(train_ids[0][0][0, 0]) == 49406


def test_train_debias_without_tokenizer_dir_keeps_the_hash_tokenizer(tmp_path):
    cfg = dataclasses.replace(train_debias.parse_args(["--device", "cpu", "--output_dir", str(tmp_path)]))
    assert cfg.tokenizer_dir == ""
    trainer = _RecordingTrainer(cfg)
    train_debias.main(cfg, trainer)
    want = HashTokenizer()([train_debias.DEFAULT_PROMPTS[0]], padding="max_length", max_length=77).input_ids
    np.testing.assert_array_equal(trainer.fits[0][0][0][0].numpy(), want)
