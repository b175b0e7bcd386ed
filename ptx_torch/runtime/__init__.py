"""The port's copy of the native runtime (``libptxrt``): the RGBE codec,
the task pool and the TCP render farm."""

from ptx_torch.runtime.api import (  # noqa: F401
    RenderFarmClient,
    RenderFarmServer,
    WorkPool,
    load_library,
    rgbe_decode,
    rgbe_encode,
    runtime_available,
)
