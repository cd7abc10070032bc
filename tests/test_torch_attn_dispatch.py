"""``ops.kernels.attn_instance``, the one rule that picks the single-block
attention pair's instance, over every head dim 1 .. 256 and sequence
length 1 .. 512, and the wrappers that hand its choice to the library
(``csrc/seg_attention.cu:nbk_seg_attention``,
``csrc/seg_attention_bwd.cu:nbk_seg_attention_bwd``); the tiled trio's
wrappers, which hand the library the caller's head dim (the library
picks the instance: ``kernels.FLASH_WGMMA``), and the wgmma counters by
head dim of both.  The card tests (``tests/test_torch_kernels_cuda.py``)
and ``chip_smoke.py`` phase 18 hold the kernels' launch counters to
them."""

import pytest
import torch

from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K

# the instance table: (d, s) -> (forward, backward)
TABLE = {(64, 20): ("wgmma", "wgmma"), (64, 256): ("wgmma", "wgmma"),
         (64, 257): ("wgmma", "wgmma"), (64, 512): ("wgmma", "wgmma"),
         (96, 1): ("wgmma", "wgmma"), (96, 256): ("wgmma", "wgmma"),
         (96, 257): (96, 96), (96, 512): (96, 96),
         (48, 160): (64, 64), (72, 160): (96, 96), (80, 256): (96, 96),
         (88, 64): (96, 96), (8, 64): (32, 32), (32, 160): (32, 32),
         (128, 256): (128, 128), (192, 256): ("wgmma", "wgmma"),
         (192, 64): ("wgmma", "wgmma"), (192, 257): (192, 192),
         (160, 256): (192, 192),
         (256, 512): (256, 256), (12, 64): (None, None),
         (264, 64): (None, None), (64, 513): (None, None),
         (96, 0): (None, None)}


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_attn_instance_over_every_head_dim_and_length(backward):
    seen = {}
    for d in range(1, 257):
        left_wgmma = False
        for s in range(0, 514):
            got = K.attn_instance(d, s, backward)
            seen[got] = seen.get(got, 0) + 1
            # refused exactly where the wrappers refuse
            assert (got is None) == (not K.attn_head_dim_ok(d)
                                     or not 1 <= s <= 512), (d, s, got)
            if got is None:
                continue
            if got == "wgmma":
                # one window of lengths from 1, at the wgmma head dims
                assert d in (64, 96, 192) and not left_wgmma, (d, s)
            else:
                # a mma.sync instance at least d wide, padding < 64 columns
                assert d <= got < d + 64 and got % 32 == 0, (d, s, got)
                left_wgmma = True
    # every instance is reached
    assert set(seen) == {None, "wgmma", 32, 64, 96, 128, 192, 256}
    for (d, s), want in TABLE.items():
        assert K.attn_instance(d, s, backward) == want[backward], (d, s)


@pytest.fixture
def keep_launch_counts():
    """Puts ``_cuda.launch_counts`` back as it was after a test whose
    wrappers launch through a fake library (and so count), so that the
    faked launches do not reach other tests of the same process."""
    saved = dict(_cuda.launch_counts)
    yield
    _cuda.launch_counts.clear()
    _cuda.launch_counts.update(saved)


class _FakeLib:
    """Records the instance each launch names (the argument after d), and
    the head dim each tiled launch names; the wgmma counters read
    ``launches[d]`` (the tiled ones ``launches[(kernel, d)]``)."""

    def __init__(self, launches=None):
        self.calls = []
        self.launches = launches or {}

    def nbk_seg_attention_wgmma_launches(self, d):
        return self.launches[d]

    def nbk_seg_attention_bwd_wgmma_launches(self, d):
        return -self.launches[d]

    def nbk_flash_fwd_wgmma_launches(self, d):
        return self.launches[("flash_fwd", d)]

    def nbk_flash_bwd_wgmma_launches(self, dkv, d):
        return self.launches[("flash_bwd_dkv" if dkv else "flash_bwd_dq",
                              d)]

    def nbk_flash_fwd(self, *a):
        self.calls.append(("flash_fwd", a[10]))       # ..., n_heads, d
        return 0

    def nbk_flash_bwd_dq(self, *a):
        self.calls.append(("flash_bwd_dq", a[14]))
        return 0

    def nbk_flash_bwd_dkv(self, *a):
        self.calls.append(("flash_bwd_dkv", a[14]))
        return 0

    def nbk_seg_attention(self, *a):
        self.calls.append(("fwd", a[10], a[11]))      # ..., d, instance
        return 0

    def nbk_seg_attention_bwd(self, *a):
        self.calls.append(("bwd", a[15], a[16]))
        return 0


@pytest.mark.usefixtures("keep_launch_counts")
@pytest.mark.parametrize("layout", ["qkv", "bshd"])
@pytest.mark.parametrize("d,s", [(64, 300), (64, 512), (96, 256), (96, 257),
                                 (88, 160), (128, 64), (192, 256),
                                 (192, 300)])
def test_wrappers_pass_attn_instance_to_the_kernels(monkeypatch, layout, d,
                                                    s):
    """The four wrappers hand the library ``attn_instance``'s choice (0
    for wgmma, else the mma.sync width): the forward's to
    ``nbk_seg_attention``, the backward's to ``nbk_seg_attention_bwd``."""
    fake = _FakeLib()
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(K, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    b, nh = 1, 2
    h = nh * d
    mask = torch.ones(b, s)
    if layout == "qkv":
        qkv = torch.zeros(b * s, 3 * h, dtype=torch.bfloat16)
        _, st = K.seg_attention(qkv, mask, nh, stats=True)
        K.seg_attention_bwd(qkv, torch.zeros(b * s, h, dtype=torch.bfloat16),
                            mask, st, nh)
    else:
        q, k, v, do = (torch.zeros(b, s, nh, d, dtype=torch.bfloat16)
                       for _ in range(4))
        _, st = K.sb_attention(q, k, v, mask, 0.1, stats=True)
        K.sb_attention_bwd(q, k, v, do, mask, st, 0.1)

    def arg(inst):
        return 0 if inst == "wgmma" else inst

    assert fake.calls == [("fwd", d, arg(K.attn_instance(d, s))),
                          ("bwd", d, arg(K.attn_instance(d, s, True)))]


def test_wgmma_counters_refuse_head_dims_without_a_wgmma_instance(
        monkeypatch):
    """A per-width count at a head dim with no wgmma instance would read
    0 whatever ran, so the counters refuse it (before reaching the
    library); at the wgmma head dims, and 0 for all of them, they read the
    library's count."""
    fake = _FakeLib({0: 6, 64: 1, 96: 2, 192: 3})
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    for d in (0, 64, 96, 192):
        assert K.seg_attention_wgmma_launches(d) == fake.launches[d]
        assert K.seg_attention_bwd_wgmma_launches(d) == -fake.launches[d]
    for d in (32, 48, 80, 88, 128, 136, 256):
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.seg_attention_wgmma_launches(d)
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.seg_attention_bwd_wgmma_launches(d)


@pytest.mark.usefixtures("keep_launch_counts")
@pytest.mark.parametrize("d", range(8, 257, 8))
def test_tiled_wrappers_pass_the_head_dim(monkeypatch, d):
    """The tiled trio's wrappers hand the library the caller's head dim at
    every d the kernels take (d <= 256, d % 8 == 0), on q, k, v views of
    one QKV buffer at a length past the single-block route's: the library
    picks the instance (csrc/flash_attention.cu, flash_attention_bwd.cu),
    wgmma + TMA where ``FLASH_WGMMA`` names one, else the mma.sync
    instance at least d wide, and its counters show which ran."""
    fake = _FakeLib()
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(K, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    b, s, nh = 1, 600, 2
    q, k, v = torch.zeros(b * s, 3 * nh * d, dtype=torch.bfloat16).view(
        b, s, 3, nh, d).unbind(2)
    do = torch.zeros(b, s, nh, d, dtype=torch.bfloat16)
    mask = torch.ones(b, s)
    o, lse = K.flash_fwd(q, k, v, mask, 0.1)
    _, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, 0.1)
    K.flash_bwd_dkv(q, k, v, mask, lse, di, do, 0.1)
    assert fake.calls == [("flash_fwd", d), ("flash_bwd_dq", d),
                          ("flash_bwd_dkv", d)]
    assert {n: _cuda.launch_counts[n] for n in K.FLASH_WGMMA} == {
        n: 1 for n in K.FLASH_WGMMA}


def test_tiled_wgmma_counters_by_head_dim(monkeypatch):
    """The tiled trio's wgmma counters read the library's count per kernel
    at d = 64, at d = 96 and at 0 for all; a head dim with no tiled wgmma
    instance is refused before the library is asked, as its count would
    read 0 whatever ran."""
    assert K.FLASH_WGMMA == {"flash_fwd": (64, 96), "flash_bwd_dq": (64, 96),
                             "flash_bwd_dkv": (64, 96)}
    launches = {("flash_fwd", 0): 10, ("flash_fwd", 64): 7,
                ("flash_fwd", 96): 3, ("flash_bwd_dq", 0): 9,
                ("flash_bwd_dq", 64): 4, ("flash_bwd_dq", 96): 5,
                ("flash_bwd_dkv", 0): 11, ("flash_bwd_dkv", 64): 5,
                ("flash_bwd_dkv", 96): 6}
    fake = _FakeLib(launches)
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    for d in (0, 64, 96):
        assert K.flash_wgmma_launches(d) == {
            n: launches[(n, d)] for n in K.FLASH_WGMMA}
    assert K.flash_wgmma_launches() == K.flash_wgmma_launches(0)
    for d in (32, 48, 80, 88, 128, 136, 192, 256):
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.flash_wgmma_launches(d)


@pytest.mark.usefixtures("keep_launch_counts")
@pytest.mark.parametrize("d", [72, 80, 88, 96])
def test_tiled_forward_hands_d96_to_wgmma(monkeypatch, d):
    """The tiled forward runs on its wgmma + TMA instance at d = 96, as the
    backward pair does, and the padded head dims 72 .. 88 stay on the
    mma.sync 96 instance (a TMA box 96 columns wide would read the next
    head's): ``FLASH_WGMMA`` names 96 and none of 72 .. 88 for every tiled
    kernel; ``flash_fwd`` hands the library the caller's d, counts the
    launch, and its wgmma counter reads the library's d = 96 count, while
    a count at 72 .. 88 is refused."""
    assert all((d in dims) == (d == 96) for dims in K.FLASH_WGMMA.values())
    fake = _FakeLib({(n, 96): 1 for n in K.FLASH_WGMMA})
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(K, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    b, s, nh = 1, 600, 2
    q, k, v = torch.zeros(b * s, 3 * nh * d, dtype=torch.bfloat16).view(
        b, s, 3, nh, d).unbind(2)
    n0 = _cuda.launch_counts["flash_fwd"]
    K.flash_fwd(q, k, v, torch.ones(b, s), 0.1)
    assert fake.calls == [("flash_fwd", d)]
    assert _cuda.launch_counts["flash_fwd"] == n0 + 1
    if d == 96:
        assert K.flash_wgmma_launches(d)["flash_fwd"] == 1
    else:
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.flash_wgmma_launches(d)
