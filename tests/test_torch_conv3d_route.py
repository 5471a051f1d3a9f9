"""Which of ``csrc/conv3d.cu``'s kernels a K6 or K7 call on the card runs,
and what it counts, checked on the CPU with a stand-in library: the
bfloat16 forward at C = Cout = 32 takes the wgmma entry and counts under
``conv3d_rfab_wg`` beside ``conv3d_rfab``; other widths, float32 and K7
(whose dx is the flipped mma.sync kernel) keep their entries."""
import pytest
import torch

from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

torch.set_num_threads(2)


class _Lib:
    """Records the entry points called; every call succeeds."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if name.startswith("conv3d_rfab"):
            def entry(*args):
                self.called.append(name)
                return 0
            entry.__name__ = name
            return entry
        raise AttributeError(name)


@pytest.fixture
def card(monkeypatch):
    """conv3d_kernel as on the card: CUDA-typed checks, the stand-in
    library, stream 0, the counts at 0."""
    lib = _Lib()
    monkeypatch.setattr(ck, "_check", lambda *a, **k: "cuda")
    monkeypatch.setattr(ck, "_lib", lambda: lib)
    monkeypatch.setattr(ck._build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(ck._build, "check_tensors", lambda *a, **k: "cuda")
    monkeypatch.setattr(ck, "LAUNCHES", {k: 0 for k in ck.LAUNCHES})
    return lib


@pytest.mark.parametrize("flip,C,Cout,want", [
    (False, 32, 32, True), (True, 32, 32, False), (False, 16, 32, False),
    (False, 32, 16, False), (False, 64, 64, False), (False, 8, 8, False),
])
def test_wg_route_is_the_forward_at_32_channels(flip, C, Cout, want):
    assert ck.wg_route(flip, C, Cout) is want


@pytest.mark.parametrize("dtype,C,Cout,entry,wg", [
    (torch.bfloat16, 32, 32, "conv3d_rfab_bf16_wg", 1),
    (torch.bfloat16, 16, 32, "conv3d_rfab_bf16", 0),
    (torch.bfloat16, 32, 64, "conv3d_rfab_bf16", 0),
    (torch.float32, 32, 32, "conv3d_rfab_f32", 0),
])
def test_forward_entry_and_counts(card, dtype, C, Cout, entry, wg):
    x = torch.zeros(2, 5, 6, 3, C, dtype=dtype)
    out = ck.conv3d_rfab(x, torch.zeros(3, 3, 3, C, Cout), torch.zeros(Cout))
    assert card.called == [entry] and out.shape == (2, 5, 6, 3, Cout)
    assert ck.LAUNCHES == {"conv3d_rfab": 1, "conv3d_rfab_bwd": 0, "conv3d_rfab_wg": wg}


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "conv3d_rfab_bwd_bf16"),
                                         (torch.float32, "conv3d_rfab_bwd_f32")])
def test_backward_at_32_channels_keeps_its_entry(card, dtype, entry):
    """K7 at C = Cout = 32 (its dx the flipped kernel inside its entry)
    counts once and never under conv3d_rfab_wg."""
    x = torch.zeros(1, 4, 5, 3, 32, dtype=dtype)
    card.conv3d_rfab_bwd_bf16_slots = lambda *a: 3
    card.conv3d_rfab_bwd_slots = lambda *a: 3
    ck.conv3d_rfab_bwd(x, torch.zeros(3, 3, 3, 32, 32), torch.zeros(1, 4, 5, 3, 32))
    assert card.called == [entry]
    assert ck.LAUNCHES == {"conv3d_rfab": 0, "conv3d_rfab_bwd": 1, "conv3d_rfab_wg": 0}
