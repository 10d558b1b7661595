"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference's ``repro.launch.serve``: the parser (every flag, default,
choice and type; the port adds ``--device`` alone), the validators'
``SystemExit`` messages on the same invalid combinations, the early
refusals of ``main`` (hybrid and audio archs, ``--prefix-cache`` on an
ssm arch) with the reference's messages, and ``main`` on the CPU for one
arch of each served family, whose summary line reports every request
done."""

import argparse

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.configs import get_config, reduced  # noqa: E402
from repro.launch import serve as R  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.launch import serve as P  # noqa: E402

PORT_ONLY = {"--device"}


def _actions(parser) -> dict:
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[tuple(a.option_strings)] = (a.dest, a.default, a.choices,
                                        a.type, a.nargs, a.const,
                                        type(a).__name__, a.required)
    return out


def test_parser_matches_reference():
    ref, port = _actions(R.build_parser()), _actions(P.build_parser())
    assert {k for k in port if not set(k) & PORT_ONLY} == set(ref)
    for k, v in ref.items():
        assert port[k] == v, k
    (dev,) = [v for k, v in port.items() if set(k) & PORT_ONLY]
    assert dev[:2] == ("device", "cuda")


INVALID = [
    # (argv, arch family the validators judge)
    ["--session-kv", "--arch", "mamba2-780m"],
    ["--session-kv", "--turns", "1"],
    ["--session-kv", "--spill-blocks", "0"],
    ["--deadline-steps", "0"],
    ["--max-steps", "0"],
    ["--num-blocks", "1"],
    ["--preempt", "lru", "--arch", "mamba2-780m"],
    ["--faults", "--arch", "mamba2-780m"],
    ["--spec-k", "3"],
    ["--draft-arch", "qwen1.5-0.5b"],
    ["--spec-mode", "ngram", "--arch", "mamba2-780m"],
    ["--spec-mode", "ngram", "--spec-k", "0"],
    ["--spec-mode", "draft"],
    ["--spec-mode", "draft", "--draft-arch", "mamba2-780m"],
    ["--spec-mode", "ngram", "--draft-arch", "qwen1.5-0.5b"],
]


def _message(fn, args, cfg):
    try:
        fn(args, cfg)
    except SystemExit as e:
        return str(e)
    return None


@pytest.mark.parametrize("argv", INVALID, ids=lambda a: " ".join(a))
def test_validators_match_reference(argv):
    ra, pa = R.build_parser().parse_args(argv), \
        P.build_parser().parse_args(argv)
    cfg = reduced(get_config(ra.arch))
    tcfg = t_reduced(t_get_config(pa.arch))
    got = [_message(fn, pa, tcfg) for fn in
           (P.validate_session_args, P.validate_spec_args,
            P.validate_fault_args)]
    want = [_message(fn, ra, cfg) for fn in
            (R.validate_session_args, R.validate_spec_args,
             R.validate_fault_args)]
    assert got == want
    assert any(w is not None for w in want)


@pytest.mark.parametrize("argv", [
    ["--arch", "zamba2-1.2b"], ["--arch", "whisper-tiny"],
    ["--arch", "mamba2-780m", "--prefix-cache"]], ids=lambda a: a[1])
def test_main_refusals_match_reference(argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        R.main()
    with pytest.raises(SystemExit) as got:
        P.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert got.value.code not in (0, None)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b",
                                  "mamba2-780m", "llava-next-mistral-7b"])
def test_main_serves_each_family_on_cpu(arch, capsys):
    snap = P.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                   "--max-new", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("2 requests, "), line
    assert "CPU" in line
    if arch == "mamba2-780m":
        assert "constant-state family (no per-token KV)" in line
        assert snap["paged_bytes"] == 0
    else:
        assert snap["paged_bytes"] > 0


def test_main_spec_and_faults_on_cpu(capsys):
    P.main(["--device", "cpu", "--requests", "2", "--max-new", "4",
            "--spec-mode", "ngram"])
    assert "spec[ngram] accept" in capsys.readouterr().out
    P.main(["--device", "cpu", "--requests", "3", "--max-new", "4",
            "--faults"])
    out = capsys.readouterr().out
    assert "faults: all armed sites fired once" in out
