"""PyTorch port: the launch seam of ``utils/kernels.py`` on the CPU.

Every kernel's wrapper binds its C entry through :func:`kernels.bind`,
checks its inputs with :func:`kernels.check_inputs` and launches through
:func:`kernels.launch`, which counts the launches. Here the C entries are
Python functions of a fake library and ``torch.cuda.device`` and the
stream are faked, so the seam runs without a card or nvcc.
"""

import ctypes
import importlib
import threading
import types
from pathlib import Path

import pytest
import torch

from gpusimilarity_tpu_torch.utils import kernels

CARD = torch.device("cuda", 1)
STREAM = 0xC0FFEE


@pytest.fixture()
def fake_cuda(monkeypatch):
    """Fakes of ``torch.cuda.device`` and the current stream; returns the
    list of devices made current, one a call."""
    current = []

    class FakeDevice:
        def __init__(self, d):
            self.d = torch.device(d)

        def __enter__(self):
            current.append(self.d)

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=STREAM))
    return current


@pytest.fixture()
def fake_library(monkeypatch):
    """Every kernel's library is one fake whose entries are Python
    functions; returns the names of the libraries loaded."""
    loaded = []

    def error_string(rc):
        return f"fake error {rc}".encode()

    def launcher(*args):
        return 0

    lib = types.SimpleNamespace(gpusim_error_string=error_string,
                                gpusim_fake_launch=launcher)

    def load(name):
        loaded.append(name)
        return kernels.Build(lib, Path(name), 0.0, "")

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "_BOUND", {})
    return loaded


def test_a_failed_launch_raises_with_the_kernel_and_the_librarys_error(
        fake_cuda, fake_library):
    before = kernels.launch_counts(kernels.KERNELS)
    with pytest.raises(RuntimeError,
                       match="^dense_phase1 kernel launch failed: fake error 7$"):
        kernels.launch("dense_phase1", lambda *args: 7, CARD, 1, 2, n=3)
    assert kernels.launch_counts(kernels.KERNELS) == before  # counts nothing
    assert fake_library == ["dense_phase1"]  # its error string, bound once
    with pytest.raises(RuntimeError, match="fake error 9"):
        kernels.launch("dense_phase1", lambda *args: 9, CARD)
    assert fake_library == ["dense_phase1"]
    assert kernels.launch_counts(kernels.KERNELS) == before


def test_launch_runs_on_the_tensors_card_with_its_stream_last(fake_cuda):
    calls = []
    kernels.launch("bitplane_phase1", lambda *args: calls.append(args) or 0, CARD,
                   11, 12, 13)
    assert calls == [(11, 12, 13, STREAM)]
    assert fake_cuda == [CARD]


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_n_launches_count_n_for_one_kernel_and_a_reset_clears(name, fake_cuda):
    before = kernels.launch_counts(kernels.KERNELS)
    kernels.launch(name, lambda *args: 0, CARD, n=3)
    after = kernels.launch_counts(kernels.KERNELS)
    assert after == {k: v + 3 * (k == name) for k, v in before.items()}
    assert kernels.launches(name) == before[name] + 3
    kernels.reset_launches()
    assert kernels.launch_counts(kernels.KERNELS) == dict.fromkeys(kernels.KERNELS, 0)


def test_counts_from_eight_threads_sum_exactly(fake_cuda):
    before = kernels.launches("bitplane_rescore")
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(2000):
            kernels.launch("bitplane_rescore", lambda *args: 0, CARD)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.launches("bitplane_rescore") == before + 8 * 2000


def test_the_served_dict_has_exactly_the_served_kernels():
    assert list(kernels.launch_counts()) == list(kernels.SERVED)
    assert set(kernels.SERVED) <= set(kernels.KERNELS)
    assert len(set(kernels.KERNELS)) == len(kernels.KERNELS)
    # each scan mode's pass, its phase 1 first, and nothing else is served
    assert kernels.SERVED == tuple(
        name for names in kernels.PASS_KERNELS.values() for name in names)
    assert [names[0] for names in kernels.PASS_KERNELS.values()] == [
        "bitplane_phase1", "dense_phase1"]


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_every_kernel_has_its_source_and_its_wrapper(name):
    assert (kernels.CSRC / f"{name}.cu").is_file()
    wrapper = importlib.import_module(f"gpusimilarity_tpu_torch.ops.{name}")
    assert wrapper.KERNEL == name


def test_bind_declares_a_signature_once_and_caches_it(fake_library):
    fn = kernels.bind("fake", "gpusim_fake_launch", [ctypes.c_void_p] * 2)
    assert fn.argtypes == [ctypes.c_void_p] * 2 and fn.restype is ctypes.c_int
    again = kernels.bind("fake", "gpusim_fake_launch", [ctypes.c_void_p] * 2)
    assert again is fn and fake_library == ["fake"]
    error = kernels.bind("fake", "gpusim_error_string", [ctypes.c_int],
                         ctypes.c_char_p)
    assert error.restype is ctypes.c_char_p and fake_library == ["fake"] * 2


def _specs():
    return [(torch.zeros((3, 4), dtype=torch.int32), torch.int32, (3, 4)),
            (torch.zeros(4, dtype=torch.int16), torch.int16, (4,)),
            (torch.ones(2), torch.float32, (2,))]


def test_check_inputs_passes_what_the_kernels_take():
    kernels.check_inputs(_specs())
    kernels.check_inputs(iter(_specs()), torch.device("cpu"))


@pytest.mark.parametrize("fault,message", [
    ("dtype", r"expected contiguous torch.int16 \(4,\), got torch.int32 \(4,\)"),
    ("shape", r"expected contiguous torch.int16 \(4,\), got torch.int16 \(5,\)"),
    ("strided", r"expected contiguous torch.int32 \(3, 4\), got torch.int32 \(3, 4\)"),
    ("device", "all inputs must be on one device"),
])
def test_check_inputs_raises_on_each_fault(fault, message):
    specs = _specs()
    if fault == "dtype":
        specs[1] = (specs[1][0].to(torch.int32), torch.int16, (4,))
    elif fault == "shape":
        specs[1] = (torch.zeros(5, dtype=torch.int16), torch.int16, (4,))
    elif fault == "strided":
        specs[0] = (torch.zeros((4, 3), dtype=torch.int32).T, torch.int32, (3, 4))
    else:
        specs[2] = (specs[2][0].to("meta"), torch.float32, (2,))
    with pytest.raises(ValueError, match=message):
        kernels.check_inputs(specs)


def test_check_inputs_holds_every_tensor_to_the_given_device():
    with pytest.raises(ValueError, match="one device"):
        kernels.check_inputs(_specs(), torch.device("meta"))
