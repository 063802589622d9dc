"""Recipe-local tooling: Emilia preprocessing + token vocabulary builder."""

import json
import os
import subprocess
import sys

import conftest  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cmd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stdout + r.stderr
    return r


def test_build_emilia_tokens(tmp_path):
    out = str(tmp_path / "tokens.txt")
    _run([sys.executable, "egs/zipvoice/local/build_emilia_tokens.py",
          "--output", out, "--extra-tokens", "[S1],[S2]"])
    lines = open(out, encoding="utf-8").read().splitlines()
    tokens = dict(line.split("\t") for line in lines)
    assert tokens["_"] == "0"
    assert "zh0" in tokens and "ang1" in tokens and "ang5" in tokens
    assert "[S1]" in tokens and "[S2]" in tokens
    # ids are dense and unique
    ids = sorted(int(v) for v in tokens.values())
    assert ids == list(range(len(lines)))
    # the pinyin-split output space is covered
    from zipvoice_tpu.frontend.tokenizer import split_pinyin

    for py in ("yang2", "zhong1", "shi4", "le5", "er2"):
        for tok in split_pinyin(py):
            assert tok in tokens, tok


def test_preprocess_emilia(tmp_path):
    meta = tmp_path / "meta.jsonl"
    rows = [
        {"id": "a1", "wav": "wavs/a1.wav", "text": "hello", "language": "en",
         "dnsmos": 3.5},
        {"id": "z1", "wav": "wavs/z1.wav", "text": "你好", "language": "zh",
         "dnsmos": 3.2},
        {"id": "j1", "wav": "wavs/j1.wav", "text": "konnichiwa",
         "language": "ja", "dnsmos": 3.9},
        {"id": "bad", "wav": "wavs/bad.wav", "text": "noisy",
         "language": "en", "dnsmos": 2.0},
    ]
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    out = tmp_path / "out"
    _run([sys.executable, "egs/zipvoice/local/preprocess_emilia.py",
          "--jsonl", str(meta), "--wav-root", "/corpus",
          "--output-dir", str(out), "--dev-utts", "0"])
    en = (out / "emilia_en_train.tsv").read_text().splitlines()
    zh = (out / "emilia_zh_train.tsv").read_text().splitlines()
    assert len(en) == 1 and en[0].startswith("a1\thello\t/corpus/wavs")
    assert len(zh) == 1 and zh[0].startswith("z1\t你好")
    # with a dev split, the first utterance per language goes to dev
    out2 = tmp_path / "out2"
    _run([sys.executable, "egs/zipvoice/local/preprocess_emilia.py",
          "--jsonl", str(meta), "--wav-root", "/corpus",
          "--output-dir", str(out2), "--dev-utts", "1"])
    assert (out2 / "emilia_en_dev.tsv").read_text().startswith("a1\t")
    assert (out2 / "emilia_en_train.tsv").read_text() == ""


def test_recipe_scripts_syntax():
    import glob

    scripts = glob.glob(os.path.join(REPO, "egs", "**", "*.sh"),
                        recursive=True)
    assert len(scripts) >= 10
    for s in scripts:
        r = subprocess.run(["bash", "-n", s], capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, f"{s}: {r.stderr}"


def test_validate_manifest(tmp_path):
    from zipvoice_tpu.data.manifest import Cut, write_manifest

    wav = tmp_path / "a.wav"
    wav.write_bytes(b"")
    good = Cut(id="a", wav=str(wav), text="hello", duration=2.0)
    bad = Cut(id="a", wav=str(tmp_path / "missing.wav"), text="",
              duration=-1.0)
    m = str(tmp_path / "cuts.jsonl.gz")
    write_manifest(m, [good, bad])
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "egs/zipvoice/utils/validate_manifest.py", m],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 1
    assert "duplicate cut id" in r.stderr
    assert "empty supervision text" in r.stderr
    assert "suspicious duration" in r.stderr
    assert "missing file" in r.stderr
    # a clean manifest passes
    write_manifest(m, [good])
    r = subprocess.run(
        [sys.executable, "egs/zipvoice/utils/validate_manifest.py", m],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr


def test_prepare_opendialog(tmp_path):
    meta = tmp_path / "en.jsonl"
    rows = [
        {"id": f"d{i}", "text": f"[S1] hi there_{i} [S2] hello",
         "path": f"audio/en/d{i}.wav"}
        for i in range(5)
    ]
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    out = tmp_path / "manifests"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "egs/zipvoice_dialog/local/prepare_opendialog.py",
         "--dataset-path", str(tmp_path), "--output-dir", str(out),
         "--dev-cuts", "2", "--skip-durations"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    from zipvoice_tpu.data.manifest import read_manifest

    dev = read_manifest(str(out / "opendialog_cuts_raw_EN-dev.jsonl.gz"))
    train = read_manifest(str(out / "opendialog_cuts_raw_EN-train.jsonl.gz"))
    assert len(dev) == 2 and len(train) == 3
    # "_" (the pad symbol) is replaced and whitespace collapsed
    assert dev[0].text == "[S1] hi there 0 [S2] hello"
    assert dev[0].wav.endswith("audio/en/d0.wav")
