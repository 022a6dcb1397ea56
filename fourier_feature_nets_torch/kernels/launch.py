"""The one launch path of every kernel wrapper in the port.

A :class:`KernelLibrary` names a ``csrc/`` source, its entry points with
their argument types and the function that turns a CUDA error code into
text. The library builds and loads at first use (:mod:`.build`); every
entry point is typed once then and kept, so a call looks nothing up.
:meth:`KernelLibrary.launch` then does the rest of a call:

* it enters a ``torch.cuda.device`` context only when the tensors'
  device is not already the current one (a host with several cards);
* it passes the raw handle of that device's current stream, which is
  the capture stream while a CUDA graph is captured;
* it raises ``RuntimeError`` with the library's error string when the
  entry point returns a non-zero ``cudaError_t``, and otherwise adds
  one to the wrapper's ``launches``.

:meth:`KernelLibrary.call` does the same for an entry point that
launches no kernel (a query) and counts nothing.

Only CUDA tensors reach it: a wrapper runs its plain twin for CPU
tensors (:func:`on_cuda`) and has no fallback from a kernel to a twin.
"""

import ctypes
import threading

import torch

from .build import BuiltLibrary, build_library

__all__ = ["INT", "LONG", "PTR", "KernelLibrary", "current_stream",
           "on_cuda"]

PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong


def on_cuda(tensor: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (whose caller runs the
    plain twin); raises for any other device."""
    kind = tensor.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no {what} kernel for {tensor.device}")


def current_stream(index: int) -> int:
    """The raw handle of CUDA device ``index``'s current stream.

    ``torch.cuda.current_stream(device).cuda_stream`` gives the same
    handle through a ``Stream`` object, which took 3-5 us a call on the
    host of an H100 where this call took 0.1-0.2 us (PERF.md, section
    6)."""
    return torch._C._cuda_getCurrentRawStream(index)


class KernelLibrary:
    """The entry points of one ``csrc/`` source.

    ``signatures`` maps each entry point to its argument types before the
    stream, which every entry point takes last as a ``void*`` and each
    returns as a ``cudaError_t`` (``int``)."""

    def __init__(self, source: str, error_entry: str, **signatures):
        self.source = source
        self.error_entry = error_entry
        self.signatures = signatures
        self.entries = {}
        self.error_string = None
        self._built = None
        self._lock = threading.Lock()

    def load(self) -> BuiltLibrary:
        """Builds (first call) and loads the library, with every entry
        point typed."""
        if self._built is None:
            with self._lock:
                if self._built is None:
                    built = build_library(self.source)
                    for name, argtypes in self.signatures.items():
                        fn = getattr(built.lib, name)
                        fn.argtypes = [*argtypes, PTR]
                        fn.restype = INT
                        self.entries[name] = fn
                    error = getattr(built.lib, self.error_entry)
                    error.argtypes = [INT]
                    error.restype = ctypes.c_char_p
                    self.error_string = lambda code: error(code).decode()
                    self._built = built
        return self._built

    def launch(self, wrapper, name: str, device: torch.device, *args) -> None:
        """Calls entry point ``name`` with ``*args`` and the current
        stream of the CUDA ``device``, building the library on first use.

        A non-zero ``cudaError_t`` raises with the library's text for it
        and counts nothing; a launch that succeeds adds one to
        ``wrapper.launches``."""
        self._call(name, device, args, "kernel launch")
        wrapper.launches += 1

    def call(self, name: str, device: torch.device, *args) -> None:
        """Calls entry point ``name`` as :meth:`launch` does but counts
        nothing: for an entry point that launches no kernel (a query)."""
        self._call(name, device, args, "call")

    def _call(self, name: str, device: torch.device, args, what: str) -> None:
        if self._built is None:
            self.load()
        index = device.index
        if index != torch.cuda.current_device():
            with torch.cuda.device(index):
                return self._call(name, device, args, what)
        code = self.entries[name](*args, current_stream(index))
        if code != 0:
            raise RuntimeError(f"{name} {what} failed: "
                               f"{self.error_string(code)} (cudaError {code})")
        return None
