"""Port parity: the text and wav front end (zipvoice_torch/frontend,
ops/stft.py) vs the JAX package's, on the same inputs.  Pure Python and
numpy, apart from the fbank, whose JAX side is one small jitted STFT."""

import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

from zipvoice_torch.bin.make_model_dir import emilia_tokens
from zipvoice_torch.infer.workload import speech_like_wav

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "reference_tokens.json")
TOKENIZERS = ("emilia", "espeak", "dialog", "libritts", "simple")

# numbers, decimals, money, years, ordinals, abbreviations, mixed Chinese
# and English, <pinyin> tags and dialog turns
SENTENCES = [
    "I have 3 apples and 1,234 oranges.",
    "Pi is about 3.14159, and e is 2.718.",
    "It costs $5.50, or £20, or $1 million.",
    "In 1999 and 2024, not in 2000 or 1066.",
    "She finished 1st, he was 22nd, they came 103rd.",
    "Mr. and Mrs. Smith met Dr. Jones at 10 Main St.",
    "About 1/2 of them, 3/4 of us, 50% of all.",
    "我们在2024年用 PyTorch 写了 3 个模型。",
    "今天是5月1日，气温25.5度。",
    "一个人不去，我们好好学习。",
    "<ni3><hao3>, world! <zhong1><guo2> is big.",
    "Hello [laughter] there, <ma5> ok?",
    "[S1] Hi there, how are you? [S2] 我很好，谢谢！ [S1] Great.",
]


def _fixture_cases():
    """The fixture cases the JAX suite runs without libespeak-ng and
    pypinyin (tests/test_token_fixtures.py)."""
    with open(FIXTURES) as f:
        cases = json.load(f)["fixtures"]
    return [c for c in cases
            if not c.get("real_espeak") and not c.get("real_pypinyin")]


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    """The Emilia vocabulary of bin/make_model_dir.py plus the dialog
    turns, so that every tokenizer maps to ids."""
    path = tmp_path_factory.mktemp("tokens") / "tokens.txt"
    with open(path, "w", encoding="utf-8") as f:
        for i, t in enumerate(emilia_tokens() + ["[S1]", "[S2]"]):
            f.write(f"{t}\t{i}\n")
    return str(path)


@pytest.mark.parametrize("name", TOKENIZERS)
def test_token_ids_match_jax(name, token_file):
    """Every tokenizer of the port gives the JAX package's tokens and ids,
    exactly, on the fixture texts and the listed sentences; each fixture
    case also keeps its committed tokens."""
    from zipvoice_tpu.frontend.tokenizer import get_tokenizer as jax_get
    from zipvoice_torch.frontend.tokenizer import get_tokenizer

    jtok, ttok = jax_get(name, token_file), get_tokenizer(name, token_file)
    cases = _fixture_cases()
    texts = [c["text"] for c in cases] + SENTENCES
    got = ttok.texts_to_tokens(texts)
    assert got == jtok.texts_to_tokens(texts)
    assert ttok.texts_to_token_ids(texts) == jtok.texts_to_token_ids(texts)
    assert any(got), "no tokens at all"
    for case, tokens in zip(cases, got):
        if case["tokenizer"] == name:
            assert tokens == case["tokens"], case["name"]


def test_emilia_vocabulary_matches_jax():
    """``bin/make_model_dir.py`` writes the Emilia vocabulary in the order
    of the JAX package's egs/zipvoice/local/build_emilia_tokens.py (and of
    tools/make_bench_model_dir.py, which takes its lists)."""
    import importlib.util

    path = os.path.join(os.path.dirname(FIXTURES), "..", "..", "egs",
                        "zipvoice", "local", "build_emilia_tokens.py")
    spec = importlib.util.spec_from_file_location("build_emilia_tokens",
                                                  path)
    egs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(egs)
    want = ["_"] + egs.PUNCT + egs.espeak_ipa_inventory()
    want += [i + "0" for i in egs.INITIALS]
    want += [f + str(t) for f in egs.FINALS for t in range(1, 6)]
    assert emilia_tokens() == want
    assert len(set(want)) == len(want)


def test_text_functions_match_jax(token_file):
    from zipvoice_tpu.frontend import text_chunking as J
    from zipvoice_torch.frontend import text_chunking as P
    from zipvoice_torch.frontend.tokenizer import DialogTokenizer

    tok = DialogTokenizer(token_file)
    for text in SENTENCES + ["no end", "  trailing space  ", "", "ends?"]:
        assert P.add_punctuation(text) == J.add_punctuation(text)
    tokens = tok.texts_to_tokens([" ".join(SENTENCES)])[0]
    for max_tokens in (4, 17, 40, 100, 1000):
        assert (P.chunk_tokens_punctuation(tokens, max_tokens)
                == J.chunk_tokens_punctuation(tokens, max_tokens))
        assert (P.chunk_tokens_dialog(tokens, max_tokens)
                == J.chunk_tokens_dialog(tokens, max_tokens))
    chunks = tok.tokens_to_token_ids(P.chunk_tokens_punctuation(tokens, 30))
    for args in ((10.0, 2.0, 0.05), (3.0, 1.0, 0.1), (100.0, 3.0, 0.08)):
        assert (P.batchify_tokens(chunks, *args)
                == J.batchify_tokens(chunks, *args))


def _wavs():
    """Prompt-like test waveforms: silent edges, a silent gap of 2.6 s
    inside (the trim keeps 1 s of it on each side), a long silent tail,
    and stereo noise."""
    gap = speech_like_wav(1, seconds=6.0)
    gap[:, 48000:48000 + 62400] = 0.0
    tail = speech_like_wav(2, seconds=2.0, edge_silence=0.0)
    tail[:, -28800:] = 0.0
    noise = 0.05 * np.random.RandomState(0).randn(2, 30000)
    return [speech_like_wav(0), gap, tail, noise.astype(np.float32)]


def test_audio_functions_match_jax(tmp_path):
    from zipvoice_tpu.frontend import audio as J
    from zipvoice_torch.frontend import audio as P

    rng = np.random.RandomState(0)
    sr = 24000
    wavs = _wavs()
    for x in wavs:
        for only_edge, trail_sil in ((False, 200), (True, 0), (False, 0)):
            got = P.remove_silence(x, sr, only_edge, trail_sil)
            want = J.remove_silence(x, sr, only_edge, trail_sil)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        for target in (0.1, 0.01):
            (g, g_rms), (w, w_rms) = P.rms_norm(x, target), J.rms_norm(x,
                                                                      target)
            assert g_rms == w_rms
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        for orig in (16000, 22050, 24000, 44100):
            np.testing.assert_allclose(P.resample(x, orig, sr),
                                       J.resample(x, orig, sr), atol=1e-6,
                                       rtol=0)
    # the silence trim removes the generated lead and keeps 100 ms of it
    trimmed = P.remove_silence(wavs[0], sr, only_edge=True, trail_sil=0)
    assert trimmed.shape[-1] < wavs[0].shape[-1]
    chunks = [(0.3 * rng.randn(1, n)).astype(np.float32)
              for n in (5000, 1200, 2400, 9000)]
    for fade in (0.0, 0.01, 0.1):
        for k in (0, 1, 2, 4):
            got = P.cross_fade_concat(chunks[:k], fade, sr)
            want = J.cross_fade_concat(chunks[:k], fade, sr)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    # 16-bit wav files round trip through either package
    for c, x in enumerate((wavs[0], wavs[3])):
        a, b = str(tmp_path / f"p{c}.wav"), str(tmp_path / f"j{c}.wav")
        P.save_wav(a, x, sr)
        J.save_wav(b, x, sr)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        np.testing.assert_array_equal(P.load_wav(b, sr), J.load_wav(a, sr))
        np.testing.assert_allclose(P.load_wav(a, sr), x, atol=2 ** -15,
                                   rtol=0)
        np.testing.assert_array_equal(P.load_wav(a, 16000),
                                      J.load_wav(a, 16000))


def test_fbank_matches_jax():
    """``melscale_fbanks`` exactly; the log-mel, mono and stereo, with the
    same frame count.  Both take an f32 FFT, whose roundings differ by
    about 1e-6 of the largest magnitude in the frame, so the logs are held
    where the mel exceeds 1e-4, to 1e-4 plus 2e-6 / mel: that is, 2e-6 in
    mel units below a mel of 0.02."""
    from zipvoice_tpu.frontend.feature import VocosFbank as JaxFbank
    from zipvoice_tpu.ops.stft import melscale_fbanks as jax_fbanks
    from zipvoice_torch.frontend.feature import VocosFbank, compute_num_frames
    from zipvoice_torch.ops.stft import melscale_fbanks

    for args in ((513, 100, 24000), (257, 80, 16000), (513, 100, 24000, 50.0,
                                                       8000.0)):
        np.testing.assert_array_equal(melscale_fbanks(*args),
                                      jax_fbanks(*args))
    rng = np.random.RandomState(1)
    inputs = [
        (1, (0.1 * rng.randn(24000 * 2 + 77)).astype(np.float32)),
        (1, speech_like_wav(3)),
        (1, (0.1 * rng.randn(2, 24000)).astype(np.float32)),  # down-mixed
        (2, (0.1 * rng.randn(2, 30011)).astype(np.float32)),
        (2, np.concatenate([speech_like_wav(4, seconds=2.0)] * 2)),
    ]
    worst = 0.0
    for channels, x in inputs:
        got = VocosFbank(channels).extract(x, 24000)
        want = JaxFbank(channels).extract(x, 24000)
        n = compute_num_frames(x.shape[-1], 256)
        assert got.shape == want.shape == (n, 100 * channels)
        mel = np.exp(want)
        keep = mel > 1e-4
        d = np.abs(got - want)[keep]
        worst = max(worst, float((d / (1e-4 + 2e-6 / mel[keep])).max()))
    assert worst <= 1.0, worst


@pytest.mark.parametrize("voice", ["es", "de", "it", "ru", "nl", "pl",
                                   "pt-br", "fr-fr"])
def test_unported_languages_raise(voice):
    """The eight first-party languages not carried over raise, and never
    fall to CharG2P, whose ids would differ from the JAX package's."""
    from zipvoice_torch.frontend.g2p import CharG2P, get_g2p
    from zipvoice_torch.frontend.tokenizer import EspeakTokenizer

    with pytest.raises(NotImplementedError, match="A3b"):
        get_g2p(voice)
    with pytest.raises(NotImplementedError):
        EspeakTokenizer(lang=voice).texts_to_tokens(["hola"])
    assert isinstance(get_g2p("sw"), CharG2P)
