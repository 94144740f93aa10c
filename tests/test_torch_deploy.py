"""PyTorch port: the deployment files of the CUDA image
(``docker/Dockerfile.cuda``) and its systemd unit
(``docker/tpusimilarity-cuda.service``), checked as far as a machine
without docker can: every ``COPY`` source exists, the build step's Python
runs against the port's build functions, the entry module imports and its
arguments parse, nothing names the JAX package or the TPU runtime, and the
unit runs the image the Dockerfile names with ``--gpus all``.
"""

import importlib
import json
import re
import shlex
from pathlib import Path

import pytest

from gpusimilarity_tpu_torch.cli import server as port_server
from gpusimilarity_tpu_torch.utils import kernels, native

REPO = Path(__file__).resolve().parents[1]
DOCKERFILE = REPO / "docker" / "Dockerfile.cuda"
UNIT = REPO / "docker" / "tpusimilarity-cuda.service"


def _instructions(path):
    """``(keyword, argument)`` per Dockerfile instruction, continuation
    lines joined and comments dropped."""
    out, pending = [], ""
    for line in path.read_text().splitlines():
        if not pending and (not line.strip() or line.lstrip().startswith("#")):
            continue
        if line.endswith("\\"):
            pending += line[:-1]
            continue
        keyword, _, arg = (pending + line).strip().partition(" ")
        out.append((keyword.upper(), arg.strip()))
        pending = ""
    return out


def _one(keyword):
    [arg] = [a for k, a in _instructions(DOCKERFILE) if k == keyword]
    return arg


def test_every_copy_source_exists():
    copies = [a for k, a in _instructions(DOCKERFILE) if k == "COPY"]
    sources = [src for arg in copies for src in shlex.split(arg)[:-1]]
    assert {"pyproject.toml", "README.md", "gpusimilarity_tpu_torch", "native"} \
        <= set(sources)
    for src in sources:
        assert (REPO / src).exists(), src
    for name in native.SOURCES:
        assert (REPO / "native" / name).is_file()


def test_the_base_has_nvcc_and_the_build_step_uses_the_ports_build_functions(monkeypatch):
    assert re.fullmatch(r"nvidia/cuda:[0-9.]+-devel-ubuntu[0-9.]+", _one("FROM"))
    [build] = [a for k, a in _instructions(DOCKERFILE)
               if k == "RUN" and a.startswith("python3 -c ")]
    code = shlex.split(build)[2]
    built = []
    monkeypatch.setattr(kernels, "build", lambda name: built.append(name) or (name, 0.0, ""))
    monkeypatch.setattr(native, "build", lambda: built.append("native") or ("native", 0.0))
    exec(compile(code, "Dockerfile.cuda", "exec"), {})
    assert built == [*kernels.SERVED, "native"]


def test_the_entry_module_imports_and_its_arguments_parse():
    entry = json.loads(_one("ENTRYPOINT"))
    cmd = json.loads(_one("CMD"))
    assert entry[:2] == ["python3", "-m"]
    module = importlib.import_module(entry[2])
    assert module is port_server
    args = port_server.parse_args(entry[3:] + cmd)
    assert (args.hostname, args.port, args.dbnames) == ("0.0.0.0", 8080,
                                                        ["/data/default.fsim"])
    assert not args.no_warmup and args.warmup_ks == "20,128"
    assert _one("STOPSIGNAL") == "SIGINT"  # the server exits 0 on SIGINT


@pytest.mark.parametrize("path", [DOCKERFILE, UNIT])
def test_nothing_names_the_jax_package_or_the_tpu_runtime(path):
    for line in path.read_text().splitlines():
        low = line.lower()
        assert "gpusimilarity_tpu/" not in low and "jax" not in low \
            and "libtpu" not in low, line


def test_the_unit_runs_the_image_with_every_card():
    [tag] = re.findall(r"docker build -f docker/Dockerfile\.cuda -t (\S+) \.",
                       DOCKERFILE.read_text())
    unit = UNIT.read_text()
    start = unit[unit.index("ExecStart=/usr/bin/docker run"):].split("\n\n")[0]
    start = start.replace("\\\n", " ")
    assert "--gpus all" in start and "--privileged" not in start
    assert re.search(rf"YOUR_REGISTRY/{re.escape(tag)}:latest /data/default\.fsim",
                     start)
    assert f"docker pull YOUR_REGISTRY/{tag}:latest" in unit
    # the JAX unit's restart policy, as it is
    jax_unit = (REPO / "docker" / "tpusimilarity.service").read_text()
    for line in ("Restart=always", "RestartSec=10", "TimeoutStartSec=0",
                 "Requires=docker.service", "WantedBy=multi-user.target"):
        assert line in jax_unit and line in unit
