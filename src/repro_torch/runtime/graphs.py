"""One decode step as one CUDA graph: the port's form of the reference's
jitted, donated step (``repro/models/decode_state.py:131``,
``jax.jit(..., donate_argnums=(2, 3))``; paged ``:1026``; driven with no
host sync at ``repro/launch/serve.py:734-738``).

A ``StepGraph`` runs a step function that reads and writes only its
carry: a dict of tensors allocated once (the KV cache leaves, positions,
block tables, the input tokens, the live mask, the output buffer) and
updated in place, so a graph recorded over their storage stays valid.
The serving states hold one per policy for the decode step and one per
(policy, chunk width) for the chunked-prefill program, whose carry is
the cache, the tables and the program's static input and output
buffers.
The caller hands the step function in on every call (only the first is
captured), so the graph holds no reference back to its owner.

* On a CUDA device the first call runs the step on a side stream (the
  warm-up ``torch.cuda.graph``'s documentation asks for, and this call's
  real step: the lazy kernel-library builds and library handles happen
  here, outside capture), then captures it once into a
  ``torch.cuda.CUDAGraph`` with a memory pool of its own. Every later
  call replays it.
* A capture that fails raises with the cause, and so does any call whose
  carry is not the one first seen (a tensor rebound, reshaped, retyped or
  moved). There is no eager fallback on the card.
* With ``enabled=False`` (the serve's eager arm) or on the CPU the same
  step runs eagerly every call, under the same carry check.

Launch accounting: a kernel wrapper counts a launch where it is called
(``kernels.build.KernelLib.check``), and during capture it is called but
nothing runs. So what capture counted is taken back, kept as the step's
launches per replay, and added again by every replay
(``KernelLib.add_replayed``).
"""

from __future__ import annotations

import time

import torch

from repro_torch.analysis.registry import hot_path


def carry_signature(carry: dict) -> dict:
    """{name: (storage pointer, shape, dtype, device)} of a carry."""
    return {name: (t.data_ptr(), tuple(t.shape), t.dtype, t.device)
            for name, t in carry.items()}


class StepGraph:
    """One step over a fixed carry: captured once and replayed on the
    card, run eagerly on the CPU or when ``enabled`` is false."""

    what = "decode step"                 # the step's name in errors

    def __init__(self, device, *, enabled: bool = True):
        self.device = torch.device(device)
        self.use_graph = enabled and self.device.type == "cuda"
        self.graph = None
        self.signature = None
        self.launches: dict = {}     # kernel library -> launches a replay
        self._replay_libs: list = []
        self.captures = self.replays = 0
        self.capture_s = 0.0

    @hot_path
    def __call__(self, fn, carry: dict) -> None:
        """Run the step ``fn(carry)`` once, ``carry`` written in place:
        the first call on the card runs and captures it, later calls
        replay that capture."""
        if self.signature is None:
            signature = carry_signature(carry)
            if self.use_graph:
                self._capture(fn, carry)     # raises: no signature kept
            else:
                fn(carry)
            self.signature = signature
            return
        self._check(carry)
        if self.use_graph:
            self.replay()
        else:
            fn(carry)

    @hot_path
    def replay(self) -> None:
        """Replay the captured step and count the launches it holds."""
        self.graph.replay()
        self.replays += 1
        for lib, n in self._replay_libs:
            lib.add_replayed(n)

    def _check(self, carry: dict) -> None:
        got = carry_signature(carry)
        if got != self.signature:
            moved = sorted(k for k in got.keys() | self.signature.keys()
                           if got.get(k) != self.signature.get(k))
            raise RuntimeError(
                f"{self.what}: carry {moved} is not the tensor first seen "
                f"(rebound, reshaped, retyped or moved); the step must "
                f"update its carry in place")

    def _capture(self, fn, carry: dict) -> None:
        from repro_torch.kernels import LIBS
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(carry)                           # warm-up: this call's step
        cur.wait_stream(side)
        before = {name: lib.launches for name, lib in LIBS.items()}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                fn(carry)
        except Exception as e:
            raise RuntimeError(f"CUDA-graph capture of the {self.what} "
                               f"failed: {e}") from e
        finally:
            # capture ran no kernel: take back what the wrappers counted
            counted = {name: lib.launches - before[name]
                       for name, lib in LIBS.items()}
            for name, lib in LIBS.items():
                lib.launches = before[name]
        self.launches = {name: n for name, n in counted.items() if n}
        self._replay_libs = [(LIBS[name], n)
                             for name, n in self.launches.items()]
        self.graph = graph
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def stats(self) -> dict:
        return {"mode": "graph" if self.use_graph else "eager",
                "captures": self.captures, "replays": self.replays,
                "capture_s": self.capture_s}
