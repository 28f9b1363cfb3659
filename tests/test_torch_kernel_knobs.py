"""CHATTERBOX_PALLAS and CHATTERBOX_FLASH in the port, against the JAX
package's reading of them.

The JAX package keeps decode attention's Pallas kernel only while
CHATTERBOX_PALLAS is "1" (``pallas_attention_v3.pallas_enabled``), and the
CFM estimator's flash kernel only while CHATTERBOX_FLASH is "1"
(``decoder._flash_active``, whose env rule is read here with the backend
taken as the TPU's): any other value, "true" and "" included, turns the
kernel off. The port reads both the same way at each call
(``pallas_enabled``, ``flash_enabled``), but has no plain route on the card:
its dispatch (``launches_kernel``) launches the kernel for a CUDA device
while the knob is on and raises, naming the knob, while it is off. A CPU
device always takes the plain version; another device type raises.
"""
import jax
import pytest
import torch

from chatterbox_tpu.models.s3gen_ref import decoder as jdec
from chatterbox_tpu.ops import pallas_attention_v3 as jpav3
from chatterbox_tpu_torch.ops import decode_attention as da
from chatterbox_tpu_torch.ops import flash_mha as fm

VALUES = ["1", "0", "true", "", None]   # None: unset
KNOB = {da: "CHATTERBOX_PALLAS", fm: "CHATTERBOX_FLASH"}
ENABLED = {da: da.pallas_enabled, fm: fm.flash_enabled}


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("value", VALUES)
def test_pallas_enabled_matches_jax(monkeypatch, value):
    _set(monkeypatch, "CHATTERBOX_PALLAS", value)
    assert da.pallas_enabled() == jpav3.pallas_enabled() == (value in ("1", None))


@pytest.mark.parametrize("value", VALUES)
def test_flash_enabled_matches_jax_env_rule(monkeypatch, value):
    _set(monkeypatch, "CHATTERBOX_FLASH", value)
    monkeypatch.setattr(jdec, "_FLASH_INTERPRET", False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")   # the rule, not the backend
    assert fm.flash_enabled() == jdec._flash_active() == (value in ("1", None))


@pytest.mark.parametrize("mod", [da, fm], ids=["decode_attention", "flash_mha"])
@pytest.mark.parametrize("value", VALUES)
def test_dispatch_reads_the_knob(monkeypatch, mod, value):
    """A CUDA device launches the kernel when the knob is on and raises,
    naming the knob and its value, when it is off (never the plain
    version); the knob is read at each call; a CPU device takes the plain
    version whatever the knob says."""
    _set(monkeypatch, KNOB[mod], value)
    cuda = torch.device("cuda")
    assert ENABLED[mod]() == (value in ("1", None))
    for _ in range(2):
        if ENABLED[mod]():
            assert mod.launches_kernel(cuda)
        else:
            with pytest.raises(RuntimeError, match=f"{KNOB[mod]}={value!r}"):
                mod.launches_kernel(cuda)
        assert not mod.launches_kernel(torch.device("cpu"))
    monkeypatch.setenv(KNOB[mod], "1")
    assert mod.launches_kernel(cuda)
    with pytest.raises(ValueError, match="unsupported device"):
        mod.launches_kernel(torch.device("meta"))
