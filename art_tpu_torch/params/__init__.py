"""Processing parameters (counterpart of :mod:`art_tpu.params`): the
`.arp` reader and the ProcParams dataclasses, copied so that the port
imports nothing of `art_tpu`."""

from art_tpu_torch.params.keyfile import KeyFile  # noqa: F401
from art_tpu_torch.params.procparams import ProcParams  # noqa: F401
