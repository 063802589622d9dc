"""The port's recipes (``egs/zipvoice_torch/``, ``egs/zipvoice_dialog_torch/``)
against the JAX package's (``egs/zipvoice/``, ``egs/zipvoice_dialog/``).

- the recipe-local tools (``build_emilia_tokens.py``,
  ``preprocess_emilia.py``, ``validate_manifest.py``,
  ``prepare_opendialog.py``) write the same files, print the same errors
  and exit with the same codes as the JAX recipes' on the inputs of
  tests/test_recipes.py (run in this process, as their ``__main__``);
- no file under the new directories names the JAX package, and every
  ``python -m zipvoice_torch.<module>`` command of their scripts uses
  options that the module's parser has.

tests/test_recipes.py's ``bash -n`` check globs ``egs/**/*.sh``, so it
reads the new scripts too.
"""

import contextlib
import glob
import gzip
import importlib
import io
import json
import logging
import os
import re
import runpy
import sys

import pytest

import conftest  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ("egs/zipvoice_torch", "egs/zipvoice_dialog_torch")


def _run(script, argv, monkeypatch):
    """(exit code, stdout, stderr) of ``script`` run as ``__main__``, with
    the root logger to itself (its ``basicConfig`` logs to its stderr)."""
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "argv", [script, *argv])
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", [])
    monkeypatch.setattr(root, "level", root.level)
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            runpy.run_path(os.path.join(REPO, script), run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
    return code, out.getvalue(), err.getvalue()


def _files(d):
    """Every file under ``d``, by relative path: its text (gzip opened)."""
    got = {}
    for path in sorted(glob.glob(os.path.join(d, "**", "*"), recursive=True)):
        if os.path.isfile(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt", encoding="utf-8") as f:
                got[os.path.relpath(path, d)] = f.read()
    return got


def _both(tmp_path, monkeypatch, script, argv_for):
    """Run the JAX recipe's ``script`` and the port's copy, each with
    ``argv_for(out_dir)``; returns their (code, stdout, stderr, files)."""
    results = []
    for side, recipe in (("jax", script), ("port", script.replace(
            "egs/zipvoice_dialog/", "egs/zipvoice_dialog_torch/").replace(
            "egs/zipvoice/", "egs/zipvoice_torch/"))):
        out = tmp_path / side
        out.mkdir()
        code, stdout, stderr = _run(recipe, argv_for(out), monkeypatch)
        results.append((code, stdout.replace(str(out), "OUT"),
                        stderr.replace(str(out), "OUT"), _files(out)))
    return results


def test_build_emilia_tokens_matches_jax(tmp_path, monkeypatch):
    want, got = _both(tmp_path, monkeypatch,
                      "egs/zipvoice/local/build_emilia_tokens.py",
                      lambda out: ["--output", str(out / "tokens.txt"),
                                   "--extra-tokens", "[S1],[S2]"])
    assert got == want and want[3]["tokens.txt"]


def test_preprocess_emilia_matches_jax(tmp_path, monkeypatch):
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
    for dev in ("0", "1"):
        sub = tmp_path / f"dev{dev}"
        sub.mkdir()
        want, got = _both(sub, monkeypatch,
                          "egs/zipvoice/local/preprocess_emilia.py",
                          lambda out: ["--jsonl", str(meta), "--wav-root",
                                       "/corpus", "--output-dir", str(out),
                                       "--dev-utts", dev])
        assert got == want and want[3]


def test_validate_manifest_matches_jax(tmp_path, monkeypatch):
    from zipvoice_tpu.data.manifest import Cut, write_manifest

    wav = tmp_path / "a.wav"
    wav.write_bytes(b"")
    good = Cut(id="a", wav=str(wav), text="hello", duration=2.0)
    bad = Cut(id="a", wav=str(tmp_path / "missing.wav"), text="",
              duration=-1.0)
    m = str(tmp_path / "cuts.jsonl.gz")
    for cuts, code in (([good, bad], 1), ([good], 0)):
        write_manifest(m, cuts)
        results = [_run(f"{d}/utils/validate_manifest.py", [m], monkeypatch)
                   for d in ("egs/zipvoice", "egs/zipvoice_torch")]
        assert results[0] == results[1] and results[0][0] == code


def test_prepare_opendialog_matches_jax(tmp_path, monkeypatch):
    meta = tmp_path / "data" / "en.jsonl"
    meta.parent.mkdir()
    meta.write_text("\n".join(json.dumps(
        {"id": f"d{i}", "text": f"[S1] hi there_{i} [S2] hello",
         "path": f"audio/en/d{i}.wav"}) for i in range(5)))
    want, got = _both(tmp_path, monkeypatch,
                      "egs/zipvoice_dialog/local/prepare_opendialog.py",
                      lambda out: ["--dataset-path", str(meta.parent),
                                   "--output-dir", str(out), "--dev-cuts",
                                   "2", "--skip-durations"])
    assert got == want
    assert sorted(want[3]) == ["opendialog_cuts_raw_EN-dev.jsonl.gz",
                               "opendialog_cuts_raw_EN-train.jsonl.gz"]


def _commands(text):
    """Each ``python -m zipvoice_torch.<module>`` command of a script, its
    continuation lines joined: (module, its --options)."""
    joined = re.sub(r"\\\n", " ", text)
    for m in re.finditer(r"python -m zipvoice_torch\.([\w.]+)([^\n]*)",
                         joined):
        yield m.group(1), set(re.findall(r"\s(--[a-z0-9-]+)", m.group(2)))


@pytest.mark.parametrize("recipe", NEW)
def test_new_recipes_call_the_port_with_its_options(recipe, capsys):
    paths = [p for p in glob.glob(os.path.join(REPO, recipe, "**", "*"),
                                  recursive=True) if os.path.isfile(p)]
    assert paths
    options = {}
    for path in paths:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert "zipvoice_tpu" not in text, path
        # the JAX recipes' tools are not run (the reference's are named)
        assert not re.search(r"(python|bash)\s+\S*egs/zipvoice(_dialog)?/",
                             text), path
        for module, used in _commands(text):
            if module not in options:
                main = importlib.import_module(f"zipvoice_torch.{module}").main
                with pytest.raises(SystemExit):
                    main(["--help"])
                options[module] = set(re.findall(
                    r"(--[a-z0-9-]+)", capsys.readouterr().out))
            assert used <= options[module], (path, module,
                                             used - options[module])
    assert options
