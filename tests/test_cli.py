"""CLI surface parity with the reference (argument_parser.hpp:29-174)."""

import pytest

from shark_tpu.cli import build_parser, config_from_args
from shark_tpu.config import SharkConfig


def _cfg(argv):
    return config_from_args(build_parser().parse_args(argv))


BASE = ["-r", "ref.fa", "-1", "s1.fq"]


def test_defaults_match_reference():
    cfg = _cfg(BASE)
    assert cfg.k == 17
    assert cfg.c == 0.6
    assert cfg.bf_gb == 1
    assert cfg.bf_bits == 1 << 33  # 1 "GB" unit = 2**33 bits
    assert cfg.min_quality == 0
    assert cfg.single is False
    assert cfg.threads == 1
    assert not cfg.paired


def test_output_defaults():
    cfg = _cfg(BASE + ["-2", "s2.fq"])
    cfg.finalize_outputs()
    assert cfg.out1_path == "sharked_sample.1"
    assert cfg.out2_path == "sharked_sample.2"
    assert cfg.paired

    cfg1 = _cfg(BASE)
    cfg1.finalize_outputs()
    assert cfg1.out1_path == "sharked_sample.1"
    assert cfg1.out2_path == ""


@pytest.mark.parametrize(
    "args,msg",
    [
        (dict(k=0), "k"),
        (dict(k=32), "k"),
        (dict(c=1.5), "c"),
        (dict(c=-0.1), "c"),
        (dict(min_quality=-1), "q"),
        (dict(threads=0), "thread"),
        (dict(bf_gb=0), "bf"),
    ],
)
def test_validation_rejects(args, msg):
    cfg = SharkConfig(fasta_path="r", sample1_path="s", **args)
    with pytest.raises(ValueError, match=msg):
        cfg.validate()


def test_resume_flag_plumbed():
    assert _cfg(BASE).resume is False
    cfg = _cfg(BASE + ["--resume", "--ssv", "o.ssv", "--max-read-len", "104"])
    assert cfg.resume is True
    assert cfg.ssv_path == "o.ssv"


def test_short_and_long_flags_agree():
    a = _cfg(BASE + ["-k", "21", "-c", "0.8", "-b", "2", "-q", "20", "-s", "-t", "4"])
    b = _cfg([
        "--reference", "ref.fa", "--sample1", "s1.fq",
        "--kmer-size", "21", "--confidence", "0.8", "--bf-size", "2",
        "--min-base-quality", "20", "--single", "--threads", "4",
    ])
    assert a == b
    assert a.bf_bits == 2 << 33


def test_missing_required_exits(capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["-r", "only_ref.fa"])


def test_multihost_flag_validation(capsys):
    from shark_tpu.cli import main

    # bad host id
    rc = main(BASE + ["--num-hosts", "2", "--host-id", "2"])
    assert rc == 1
    assert "host-id" in capsys.readouterr().err
    # multi-host without coordinator
    rc = main(BASE + ["--num-hosts", "2", "--host-id", "0"])
    assert rc == 1
    assert "coordinator" in capsys.readouterr().err


def test_stats_json_flag(tmp_path, capsys):
    """--stats-json writes one machine-readable JSON object with the run's
    counters (no reference analogue; observability extra)."""
    import json

    from shark_tpu.cli import main

    fa = tmp_path / "g.fa"
    core = b"ACGTTGCAAGGCTTAGCCGATTCAGGCATTCGA" * 3
    fa.write_bytes(b">g0\n" + core + b"\n")
    fq = tmp_path / "s.fq"
    fq.write_bytes(
        b"@r0\n" + core[:60] + b"\n+\n" + b"I" * 60 + b"\n"
        b"@r1\n" + b"T" * 60 + b"\n+\n" + b"I" * 60 + b"\n"
    )
    stats_path = tmp_path / "stats.json"
    rc = main([
        "-r", str(fa), "-1", str(fq),
        "-o", str(tmp_path / "o.fq"),
        "--ssv", str(tmp_path / "o.ssv"),
        "--stats-json", str(stats_path),
        "--backend", "cpu", "--batch-size", "64",
    ])
    capsys.readouterr()
    assert rc == 0
    st = json.loads(stats_path.read_text())
    assert st["n_reads"] == 2
    assert st["n_associations"] == 1  # only r0 maps to g0
    assert st["n_genes"] == 1
    assert st["reads_per_sec"] > 0
    # the device the run used, as jax reports it
    assert st["device"]["platform"] == "cpu"
    assert st["device"]["count"] == 1
    assert st["device"]["kind"]
    ssv = (tmp_path / "o.ssv").read_text()
    assert ssv == "r0 g0\n"


def test_missing_input_file_fails_fast(tmp_path):
    from shark_tpu.pipeline import run_pipeline

    cfg = SharkConfig(
        fasta_path=str(tmp_path / "missing.fa"),
        sample1_path=str(tmp_path / "missing.fq"),
    )
    with pytest.raises(FileNotFoundError):
        run_pipeline(cfg)


def test_probe_flag():
    assert _cfg(BASE).probe == "auto"
    assert _cfg(BASE + ["--probe", "classic"]).probe == "classic"
    assert _cfg(BASE + ["--probe", "hashed"]).probe == "hashed"
    with pytest.raises(SystemExit):  # argparse choices reject unknowns
        _cfg(BASE + ["--probe", "fast"])
    with pytest.raises(ValueError, match="probe"):
        SharkConfig(probe="fast").validate()


def test_compile_cache_flag():
    from shark_tpu.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["-r", "g.fa", "-1", "s.fq", "--compile-cache", "/tmp/x"]
    )
    assert config_from_args(args).compile_cache == "/tmp/x"
    args = build_parser().parse_args(
        ["-r", "g.fa", "-1", "s.fq", "--compile-cache", ""]
    )
    assert config_from_args(args).compile_cache == ""
    # default on, at the fixed path inside the checkout
    from shark_tpu.config import DEFAULT_COMPILE_CACHE

    args = build_parser().parse_args(["-r", "g.fa", "-1", "s.fq"])
    assert config_from_args(args).compile_cache == DEFAULT_COMPILE_CACHE
    assert SharkConfig().compile_cache == DEFAULT_COMPILE_CACHE


def _recorded_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append(k))
    return calls


def test_compile_cache_env_var_wins(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, jax reads it itself and the
    program sets no cache directory in code, whatever --compile-cache says."""
    from shark_tpu.config import DEFAULT_COMPILE_CACHE, compile_cache_dir
    from shark_tpu.pipeline import use_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    calls = _recorded_updates(monkeypatch)
    for requested in (DEFAULT_COMPILE_CACHE, str(tmp_path / "flag"), ""):
        assert compile_cache_dir(requested) is None
        use_compile_cache(requested)
    assert "jax_compilation_cache_dir" not in calls
    assert not (tmp_path / "flag").exists()


def test_compile_cache_default_and_disable(tmp_path, monkeypatch):
    """Without the env var: the default is <checkout>/.jax_cache, an
    explicit directory overrides it, and '' disables the cache."""
    import pathlib

    from shark_tpu.config import DEFAULT_COMPILE_CACHE, compile_cache_dir
    from shark_tpu.pipeline import use_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = pathlib.Path(__file__).resolve().parents[1]
    assert DEFAULT_COMPILE_CACHE == str(checkout / ".jax_cache")
    assert compile_cache_dir(DEFAULT_COMPILE_CACHE) == DEFAULT_COMPILE_CACHE
    assert compile_cache_dir("") is None
    calls = _recorded_updates(monkeypatch)
    use_compile_cache("")
    assert calls == []
    use_compile_cache(str(tmp_path / "mine"))
    assert calls == ["jax_compilation_cache_dir"]
    assert (tmp_path / "mine").is_dir()


@pytest.mark.parametrize("backend", ["gpu", "cuda", "cpu", "native", ""])
def test_backend_flag_accepts(backend):
    cfg = _cfg(BASE + ["--backend", backend])
    assert cfg.backend == backend
    cfg.validate()


@pytest.mark.parametrize(
    "backend,platform",
    [("gpu", "cuda"), ("cuda", "cuda"), ("cpu", "cpu"), ("native", None),
     ("", None)],
)
def test_backend_pins_jax_platform(backend, platform, monkeypatch):
    """--backend gpu pins jax to CUDA (jax's own "gpu" alias would also
    demand ROCm); native and "" leave jax's platform choice alone."""
    import jax

    from shark_tpu.pipeline import use_backend

    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.append((k, v))
    )
    use_backend(backend)
    assert calls == ([("jax_platforms", platform)] if platform else [])


@pytest.mark.parametrize("backend", ["rocm", "metal"])
def test_backend_flag_rejects_unknown(backend):
    with pytest.raises(SystemExit):  # argparse choices
        _cfg(BASE + ["--backend", backend])
    with pytest.raises(ValueError, match="backend"):
        SharkConfig(backend=backend).validate()


def test_device_info_counts_mesh_devices():
    """stats["device"] names the platform, kind and the number of devices
    the classifier runs on: the mesh size for the data-parallel path."""
    import jax

    from __graft_entry__ import _tiny_index
    from shark_tpu.classify.step import Classifier
    from shark_tpu.parallel.data_parallel import DataParallelClassifier
    from shark_tpu.pipeline import device_info

    index, _ = _tiny_index()
    dev = jax.devices()[0]
    want = {"platform": dev.platform, "kind": dev.device_kind}
    assert device_info(Classifier(index)) == {**want, "count": 1}
    dp = DataParallelClassifier(index, n_devices=4)
    assert device_info(dp) == {**want, "count": 4}
