"""The one traffic generator.  It reads a configuration (configs/*.json)
and a traffic mix (traffic/*.json), makes the inputs on the device from the
seed, and drives a system through the measured window.

A configuration's "operation" says what is computed:
  "mul"            the product of operands of "bits_a" and "bits_b" bits;
  "sqrmod_fermat"  the square of a residue mod 2^"N"+1.
A traffic mix's "loop" says how the calls arrive:
  "closed"  one caller: a call, a synchronise of its stream, the next call;
            each call takes the next entry of a pool of "pool" inputs;
  "chain"   each call takes the previous call's output, enqueued at once,
            with no synchronise until the window ends; the host runs at
            most "max_lead" calls ahead of the device (0: no limit).
Inputs are uniform canonical base-2^16 digits with the top bit set (an
operand of exactly its bits, a residue of full width), drawn in one call
per operand from a torch.Generator on the device seeded with the seed, so
that one seed gives the same inputs on one kind of device."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

from bignum_bench.window import CHECK_SPAN, PRODUCT_SPAN, WINDOW_SPAN

DIGIT_BITS = 16
LOOPS = ("closed", "chain")


def random_digits(g: torch.Generator, rows: int, bits: int, device) -> torch.Tensor:
    """[rows, ceil(bits/16)] int32 digits of uniform bits-bit numbers, top bit set."""
    n = -(-bits // DIGIT_BITS)
    d = torch.randint(0, 1 << DIGIT_BITS, (rows, n), generator=g, device=device,
                      dtype=torch.int32)
    top = (bits - 1) % DIGIT_BITS
    d[:, -1] = (d[:, -1] & ((1 << top) - 1)) | (1 << top)
    return d


def make_inputs(config: dict, traffic: dict, seed: int, device) -> list[tuple]:
    """The pool of inputs, one tuple of arguments per entry."""
    if traffic["loop"] not in LOOPS:
        raise ValueError(f"traffic {traffic['name']!r}: loop {traffic['loop']!r} not in {LOOPS}")
    rows = traffic.get("pool", 1) if traffic["loop"] == "closed" else 1
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    op = config["operation"]
    if op == "mul":
        a = random_digits(g, rows, config["bits_a"], device)
        b = random_digits(g, rows, config["bits_b"], device)
        return [(a[i], b[i]) for i in range(rows)]
    if op == "sqrmod_fermat":
        if traffic["loop"] == "chain" and config["N"] % DIGIT_BITS:
            raise ValueError("a chain needs N a multiple of 16")
        x = random_digits(g, rows, config["N"], device)
        return [(x[i],) for i in range(rows)]
    raise ValueError(f"configuration {config['name']!r}: unknown operation {op!r}")


def syncer(device):
    """A synchronise of the whole device (a no-op on the CPU)."""
    dev = torch.device(device)
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)


def stream_syncer(device):
    """A synchronise of the stream the program runs on: a caller's wait for
    its product, which the benchmark's own checks on their stream do not
    hold up."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.current_stream(dev).synchronize()


def spans(on: bool):
    """name -> a context that records a profiler span, or does nothing."""
    if not on:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


class OutputCheck:
    """Judges every output of a closed loop during the window, off the
    program's stream: the first output of each pool entry is kept, every
    later one is compared with it on the device.  The kept outputs are then
    judged against the reference once the window has closed (judge.py),
    so every product of the window is held to the reference.

    An output's check is launched while the next product runs, between
    that product's call and its synchronise, where the host waits on the
    device anyway; the output is held until then."""

    def __init__(self, pool: int, like: torch.Tensor, span, stream=None):
        self.kept = torch.zeros((pool,) + tuple(like.shape), dtype=like.dtype,
                                device=like.device)
        self.have = [False] * pool
        self.count = [0] * pool
        self.differs = torch.zeros(pool, dtype=torch.int64, device=like.device)
        self.bad_shape = [0] * pool
        self.span = span
        # the warm-up's check passes its stream on, whose memory is then cached
        if stream is None and like.device.type == "cuda":
            stream = torch.cuda.Stream(like.device)
        self.stream = stream
        self.pending: tuple[int, torch.Tensor] | None = None
        self.checked: torch.Tensor | None = None
        self.done: torch.cuda.Event | None = None

    def hold(self, j: int, out: torch.Tensor) -> None:
        """Take the output of pool entry j; launch the check of the one before."""
        self.flush()
        self.pending = (j, out)

    def flush(self) -> None:
        """Launch the check of the held output, if any.  It runs on the
        check's stream beside the next product (the output is complete: its
        product was synchronised); the output stays referenced until the
        next flush, which first makes the program's stream wait for the
        check, so that its memory is reused only after the check read it."""
        if self.stream is not None and self.done is not None:
            torch.cuda.current_stream(self.kept.device).wait_event(self.done)
        self.checked = None
        if self.pending is None:
            return
        j, out = self.pending
        self.pending = None
        self.count[j] += 1
        if out.shape != self.kept.shape[1:]:
            self.bad_shape[j] += 1
            return
        with self.span(CHECK_SPAN):
            ctx = torch.cuda.stream(self.stream) if self.stream is not None \
                else contextlib.nullcontext()
            with ctx:
                if not self.have[j]:
                    self.kept[j].copy_(out)
                    self.have[j] = True
                else:
                    self.differs[j] += (out != self.kept[j]).any()
            if self.stream is not None:
                self.done = torch.cuda.Event()
                self.done.record(self.stream)
        self.checked = out


@dataclasses.dataclass
class Window:
    calls: int                       # calls completed in the window
    seconds: float                   # the window, from the first call to the last completion
    final: torch.Tensor | None = None  # the chain's last output


def closed_loop(system, inputs: list[tuple], seconds: float, sync, wait,
                check: OutputCheck | None, span, min_calls: int = 1) -> Window:
    """Calls, each followed by wait(), until one completes past `seconds`
    (and at least min_calls have); then sync().  The check of each output
    is launched during the next call, and the last one's before the
    window's closing synchronise."""
    i = 0
    start = time.perf_counter()
    with span(WINDOW_SPAN):
        while True:
            j = i % len(inputs)
            with span(PRODUCT_SPAN):
                out = system(*inputs[j])
                if check is not None:
                    check.hold(j, out)
                del out
                wait()
            i += 1
            if time.perf_counter() - start >= seconds and i >= min_calls:
                break
        if check is not None:
            check.flush()
        sync()
    return Window(i, time.perf_counter() - start)


def chain(system, x: torch.Tensor, seconds: float, sync, max_lead: int, span) -> Window:
    """x <- system(x), enqueued back to back until `seconds` have passed on
    the host, then one synchronise; the host waits only where it runs
    max_lead calls ahead of the device."""
    lead: collections.deque = collections.deque()
    on_card = x.device.type == "cuda"
    n = 0
    start = time.perf_counter()
    with span(WINDOW_SPAN):
        while time.perf_counter() - start < seconds:
            with span(PRODUCT_SPAN):
                x = system(x)
            n += 1
            if max_lead and on_card:
                ev = torch.cuda.Event()
                ev.record()
                lead.append(ev)
                if len(lead) > max_lead:
                    lead.popleft().synchronize()
        sync()
    return Window(n, time.perf_counter() - start, x)


def drive(system, inputs: list[tuple], traffic: dict, seconds: float, device,
          check: OutputCheck | None = None, trace: bool = False) -> Window:
    """One window of the traffic's loop over the system."""
    sync, span = syncer(device), spans(trace)
    if traffic["loop"] == "closed":
        return closed_loop(system, inputs, seconds, sync, stream_syncer(device), check, span)
    return chain(system, inputs[0][0], seconds, sync, traffic.get("max_lead", 0), span)
