"""The port's NVML meter (`energy.meter.NvmlMeter`) on the CPU, against a
stand-in for the NVML library's functions and a scripted energy counter;
the engine's per-call metering; and the characterization campaign's
tokens against the reference's after the engine-wide warm-up.  The
card's own counter is read by the gpu-marked test in
tests/test_torch_kernels_gpu.py.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.core.characterize import run_campaign
from repro_torch.energy import meter as meter_mod
from repro_torch.energy.meter import NvmlError, NvmlMeter, WallClockMeter
from repro_torch.launch import serve as port_serve
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import GenStats, InferenceEngine

UUIDS = ("GPU-0a1b2c3d-0000-1111-2222-333344445555",
         "GPU-9f8e7d6c-aaaa-bbbb-cccc-ddddeeeeffff")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as every port test file (see test_torch_serve.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    """A host clock that moves only when told to, and by each counter read."""

    def __init__(self, read_s=1e-5):
        self.now, self.read_s = 0.0, read_s

    def perf_counter(self):
        return self.now


class Counter:
    """A counter that steps every `period_s`, each step adding the energy
    drawn since the last at `watts(t)` (integrated finely over each step,
    so the integral keeps its resolution however long a test runs)."""

    def __init__(self, clock, period_s=0.02, watts=lambda t: 100.0):
        self.clock, self.period_s, self.watts = clock, period_s, watts
        self.seen = {}
        self.step_j = []        # the energy of each period so far

    def mj(self):
        self.clock.now += self.clock.read_s
        k = int(self.clock.now / self.period_s)
        if k not in self.seen:
            while len(self.step_j) < k:
                i = len(self.step_j)
                self.step_j.append(self.joules(i * self.period_s, (i + 1) * self.period_s))
            self.seen[k] = int(round(sum(self.step_j[:k]) * 1e3))
        return self.seen[k]

    def joules(self, a, b, n=20_000):
        if b <= a:
            return 0.0
        t = np.linspace(a, b, n + 1)
        w = np.array([self.watts(x) for x in t])
        return float(np.sum((w[1:] + w[:-1]) / 2) * (b - a) / n)


class LateCounter(Counter):
    """A counter that reports each period's energy a step late, so that a
    load's rising and falling edges reach its reading a period after they
    happen, as the card's counter can report them."""

    def mj(self):
        self.clock.now += self.clock.read_s
        k = int(self.clock.now / self.period_s)
        if k not in self.seen:
            while len(self.step_j) < k:
                i = len(self.step_j)
                self.step_j.append(self.joules(i * self.period_s, (i + 1) * self.period_s))
            self.seen[k] = int(round(sum(self.step_j[:max(k - 1, 0)]) * 1e3))
        return self.seen[k]


def busy_counter(clock, cls=Counter, period_s=0.05):
    """A counter over a card that draws 400 W in the stretches `work`
    runs and 60 W between them, and `work(d)`, which runs one of `d` s."""
    busy = []
    counter = cls(clock, period_s=period_s,
                  watts=lambda t: 400.0 if any(a <= t < b for a, b in busy) else 60.0)

    def work(d):
        busy.append((clock.now, clock.now + d))
        clock.now += d

    return counter, work, busy


class StubNvml:
    """Python stand-ins for the ctypes functions NvmlMeter calls.  Return
    codes come from `rc` (name -> code); the counter from `counter()`."""

    def __init__(self, counter=lambda: 1234567, rc=None, uuids=UUIDS):
        self.counter, self.rc, self.uuids = counter, rc or {}, uuids
        self.reads = 0

    def _code(self, name):
        return self.rc.get(name, 0)

    def nvmlInit_v2(self):
        return self._code("nvmlInit_v2")

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.uuids)
        return self._code("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = 100 + i
        return self._code("nvmlDeviceGetHandleByIndex_v2")

    def nvmlDeviceGetUUID(self, handle, buf, n):
        buf.value = self.uuids[handle.value - 100].encode()
        return self._code("nvmlDeviceGetUUID")

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, mj):
        assert handle.value == 101          # the torch device's own card
        self.reads += 1
        mj._obj.value = self.counter()
        return self._code("nvmlDeviceGetTotalEnergyConsumption")


@pytest.fixture
def card(monkeypatch):
    """torch.cuda as a card whose UUID is UUIDS[1]'s would give it."""
    props = types.SimpleNamespace(uuid=UUIDS[1][4:])
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(meter_mod, "time", c)
    return c


class TestNvmlMeter:
    def test_contract_and_totals(self, card, clock):
        counter = Counter(clock, period_s=0.02, watts=lambda t: 250.0)
        meter = NvmlMeter("cuda", lib=StubNvml(counter.mj))
        assert meter.device == torch.device("cuda", 0)
        assert meter.uuid == UUIDS[1][4:]

        def work(seconds):
            clock.now += seconds
            return "out"

        out, s1, j1 = meter.measure(lambda: work(0.3))
        assert out == "out"
        assert s1 == pytest.approx(0.3, abs=1e-4)
        assert meter.idle_w == pytest.approx(250.0, rel=1e-3)
        # mJ -> J: 250 W over fn's 0.3 s, the head and tail charged at idle
        assert j1 == pytest.approx(250.0 * 0.3, abs=5e-3)
        assert meter.last["window_j"] == pytest.approx(j1 + 250.0 * meter.last["idle_s"],
                                                       abs=5e-3)
        _, s2, j2 = meter.measure(lambda: work(0.55))
        assert j2 == pytest.approx(250.0 * 0.55, abs=5e-3)
        assert meter.total_s == pytest.approx(s1 + s2)
        assert meter.total_j == pytest.approx(j1 + j2)

    def test_windows_open_and_close_on_counter_steps(self, card, clock):
        """A short busy call (400 W) between idle stretches (60 W), at
        several phases of the counter's 50 ms steps: the window opens on a
        step (the previous window's closing one when the counter has not
        stepped since), closes on the second step after the call (the
        counter may report a load's edge a step late), reads the counter's
        energy between them, and charges its idle head and tail at the idle
        power measured over one step before it."""
        busy = []
        period = 0.05
        counter = Counter(clock, period_s=period,
                          watts=lambda t: 400.0 if any(a <= t < b for a, b in busy) else 60.0)
        meter = NvmlMeter("cuda:0", lib=StubNvml(counter.mj))

        def work(d=0.12):
            busy.append((clock.now, clock.now + d))
            clock.now += d

        def on_step(t):
            return abs(t / period - round(t / period)) < 1e-3

        # pauses after the last window closed: past the next step (a fresh
        # window), inside the period (reuse, an idle head), none (reuse)
        for pause in (0.0113, 0.1671, 0.0213, 0.0):
            clock.now += pause
            fresh = pause > period
            last_closed = meter.last.get("closed")
            _, s, j = meter.measure(work)
            a, b = busy[-1]
            assert s == pytest.approx(b - a, abs=1e-4)
            opened, closed = meter.last["opened"], meter.last["closed"]
            assert on_step(closed) and period < closed - b < 2 * period
            assert meter.last["idle_s"] == pytest.approx(closed - opened - s, abs=1e-9)
            if last_closed is not None and not fresh:
                assert opened == last_closed and a - opened >= pause
            else:
                assert on_step(opened) and 0 <= a - opened < 1e-4
                assert meter.idle_w == pytest.approx(60.0, rel=5e-3)
            steps = [counter.seen[round(t / period)] for t in (opened, closed)]
            assert meter.last["window_j"] == (steps[1] - steps[0]) / 1e3
            assert j == pytest.approx(400.0 * s, abs=0.02)

    def test_a_load_edge_reported_a_step_late(self, card, clock):
        """On a counter that reports a load's edges a step late, a window
        closed on the first step after the call would miss the call's last
        part, and an idle power measured over the first step after device
        work would hold that work's tail.  The meter keeps both of a
        window's edges a whole step from device work: a fresh window after
        work outside any window, then back-to-back ones, read the calls'
        energy and the idle power."""
        counter, work, busy = busy_counter(clock, LateCounter)
        meter = NvmlMeter("cuda", lib=StubNvml(counter.mj))
        work(0.33)                  # ends inside a period, before any window
        for d in (0.12, 0.031, 0.2, 0.07):
            _, s, j = meter.measure(lambda: work(d))
            assert s == pytest.approx(d, abs=1e-4)
            assert meter.idle_w == pytest.approx(60.0, rel=5e-3)
            assert j == pytest.approx(400.0 * d, abs=0.02)

    def test_work_between_windows_is_kept_out_of_the_next(self, card, clock):
        """Device work between two windows, inside the period after the
        first one's closing step (the engine's graph captures): after
        `invalidate` the next window opens a whole step past that work and
        measures the idle power anew, so the work is not charged at the
        idle power in its head."""
        counter, work, busy = busy_counter(clock)
        meter = NvmlMeter("cuda", lib=StubNvml(counter.mj))
        meter.measure(lambda: work(0.1))
        closed = meter.last["closed"]
        work(0.02)
        assert int(clock.now / 0.05) == int(closed / 0.05)     # the counter has not stepped
        meter.invalidate()
        _, s, j = meter.measure(lambda: work(0.1))
        assert meter.last["opened"] >= busy[-2][1] + 0.05
        assert meter.idle_w == pytest.approx(60.0, rel=5e-3)
        assert j == pytest.approx(400.0 * s, abs=0.02)

    def test_begin_and_end_span_several_calls_as_measure_spans_one(self, card, clock):
        """A window opened by `begin` and closed by `end` around several
        busy stretches with host gaps between them (a training loop's
        steps) reads what one `measure` over the same stretches reads: the
        seconds from `begin` to the end of the work, the work's energy and
        the gaps' at idle power, on the counter's steps."""
        counter, work, busy = busy_counter(clock, LateCounter)
        meter = NvmlMeter("cuda", lib=StubNvml(counter.mj))
        work(0.2)                   # device work before the window, as a capture step

        def steps():
            for d in (0.03, 0.05, 0.04):
                work(d)
                clock.now += 0.007  # the host between steps

        window = meter.begin()
        start = clock.now
        steps()
        stop = clock.now
        s, j = meter.end(window)
        assert s == pytest.approx(stop - start, abs=1e-4)
        assert meter.last["opened"] >= busy[0][1] + 0.05
        assert meter.idle_w == pytest.approx(60.0, rel=5e-3)
        assert j == pytest.approx(400.0 * 0.12 + 60.0 * (s - 0.12), abs=0.02)
        assert meter.total_s == pytest.approx(s) and meter.total_j == pytest.approx(j)
        work(0.2)
        meter.invalidate()
        _, s2, j2 = meter.measure(steps)
        assert s2 == pytest.approx(s, abs=1e-3) and j2 == pytest.approx(j, abs=0.05)

    def test_raises_on_a_nonzero_return_code(self, card, clock):
        for name in ("nvmlInit_v2", "nvmlDeviceGetCount_v2", "nvmlDeviceGetUUID"):
            with pytest.raises(NvmlError, match=name):
                NvmlMeter("cuda", lib=StubNvml(rc={name: 1}))
        lib = StubNvml()
        meter = NvmlMeter("cuda", lib=lib)
        lib.rc["nvmlDeviceGetTotalEnergyConsumption"] = 15
        with pytest.raises(NvmlError, match="returned 15"):
            meter.measure(lambda: None)

    def test_raises_when_the_counter_stops(self, card, clock):
        def stuck():
            clock.now += 1e-3
            return 42

        meter = NvmlMeter("cuda", lib=StubNvml(counter=stuck))
        with pytest.raises(NvmlError, match="did not step"):
            meter.measure(lambda: None)

    def test_raises_without_the_card_or_the_library(self, card, monkeypatch):
        with pytest.raises(NvmlError, match="no NVML device"):
            NvmlMeter("cuda", lib=StubNvml(uuids=UUIDS[:1]))
        with pytest.raises(ValueError, match="CUDA device"):
            NvmlMeter("cpu", lib=StubNvml())
        monkeypatch.setattr(meter_mod, "NVML_LIBRARY", "libnvidia-ml-absent.so.1")
        with pytest.raises(NvmlError, match="cannot load"):
            NvmlMeter("cuda")

    def test_library_signatures_are_declared(self, monkeypatch):
        """load_nvml declares every call's argument and result types."""
        class Fn:
            pass

        fake = types.SimpleNamespace(**{name: Fn() for name in meter_mod._SIGNATURES})
        monkeypatch.setattr(ctypes, "CDLL", lambda name: fake)
        lib = meter_mod.load_nvml()
        for name, args in meter_mod._SIGNATURES.items():
            assert getattr(lib, name).argtypes == args
            assert getattr(lib, name).restype is ctypes.c_int


class TestEngineMetering:
    @pytest.fixture(scope="class")
    def small(self):
        cfg = port_serve.get_config("llama2-7b-reduced")
        params = port_serve.get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                                    torch.device("cpu"))
        return cfg, params

    def test_cpu_engines_keep_the_wall_clock_meter(self):
        for kv in (True, False):
            eng = port_serve.build_engine("llama2-7b-reduced", kv_cache=kv, device="cpu")
            assert type(eng.meter) is WallClockMeter and eng.step_meter is eng.meter

    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_a_per_call_meter_wraps_the_whole_generate(self, small, kv_cache):
        cfg, params = small

        class CallMeter:
            per_call = True

            def __init__(self):
                self.calls = 0

            def measure(self, fn):
                self.calls += 1
                return fn(), 1.0, 7.5

        meter = CallMeter()
        eng = InferenceEngine(cfg, params, kv_cache=kv_cache, meter=meter, bucket=8,
                              device="cpu")
        toks = np.ones((2, 8), np.int32)
        out, stats = eng.generate({"tokens": toks}, 4)
        assert meter.calls == 1
        assert stats.energy_j == 7.5 and stats.call_energy_j == 7.5
        assert stats.prefill_s > 0 and stats.decode_s > 0
        ref, _ = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=8,
                                 device="cpu").generate({"tokens": toks}, 4)
        np.testing.assert_array_equal(out, ref)

    def fake_generate(self, eng, work, d, out):
        """Replace `eng`'s KV-off run by `work(d)` (one call's device work
        on the scripted clock) returning `out` and its stats."""
        def run(batch, max_new):
            work(d)
            return out, GenStats(prefill_s=d / 4, decode_s=3 * d / 4, tau_in=8,
                                 tau_out=max_new)
        eng._generate_uncached = run

    def test_short_calls_repeat_inside_one_window(self, small, card, clock, monkeypatch):
        """With `min_window_s` a per-call meter's window holds the call
        repeated until the repeats have lasted that long; the stats carry
        one call's mean seconds and joules and the repeats."""
        cfg, params = small
        monkeypatch.setattr(engine_mod, "time", clock)
        counter, work, busy = busy_counter(clock)
        meter = NvmlMeter("cuda", lib=StubNvml(counter.mj))
        eng = InferenceEngine(cfg, params, kv_cache=False, meter=meter, min_window_s=0.25,
                              bucket=8, device="cpu")
        out = np.arange(8, dtype=np.int32).reshape(2, 4)
        for d, n in ((0.03, 9), (0.1, 3), (0.3, 1)):
            self.fake_generate(eng, work, d, out)
            got, stats = eng.generate({"tokens": np.ones((2, 8), np.int32)}, 4)
            assert got is out and stats.repeats == n
            assert stats.runtime_s == pytest.approx(d)
            assert stats.energy_j == pytest.approx(400.0 * d, abs=0.02 / n)
            assert meter.last["window_j"] == pytest.approx(
                n * stats.energy_j + 60.0 * meter.last["idle_s"], abs=0.02)

    def test_a_capture_before_the_window_invalidates_its_step(self, small, card, clock,
                                                                monkeypatch):
        """When `_prepare` captured graphs (device work), generate has the
        meter open its window a step past it rather than on the previous
        window's closing step."""
        cfg, params = small
        monkeypatch.setattr(engine_mod, "time", clock)
        counter, work, busy = busy_counter(clock)
        meter = NvmlMeter("cuda", lib=StubNvml(counter.mj))
        eng = InferenceEngine(cfg, params, kv_cache=False, meter=meter, bucket=8,
                              device="cpu")
        self.fake_generate(eng, work, 0.1, None)
        eng.generate({"tokens": np.ones((2, 8), np.int32)}, 4)
        eng._prepare = lambda batch, max_new: work(0.02) or True
        _, stats = eng.generate({"tokens": np.ones((2, 8), np.int32)}, 4)
        assert meter.last["opened"] >= busy[-2][1] + 0.05
        assert stats.energy_j == pytest.approx(400.0 * 0.1, abs=0.02)

    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_repeated_calls_give_the_calls_tokens(self, small, kv_cache, monkeypatch):
        """A generate repeated inside its window returns the tokens of one
        unrepeated call, and charges each repeat the window's joules over
        their count."""
        cfg, params = small

        class TickClock:
            now = 0.0

            def perf_counter(self):
                self.now += 0.01
                return self.now

        class CallMeter:
            per_call = True

            def measure(self, fn):
                return fn(), 1.0, 9.0

        monkeypatch.setattr(engine_mod, "time", TickClock())
        eng = InferenceEngine(cfg, params, kv_cache=kv_cache, meter=CallMeter(),
                              min_window_s=0.5, bucket=8, device="cpu")
        toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
        out, stats = eng.generate({"tokens": toks}, 4)
        assert stats.repeats > 1 and stats.energy_j == pytest.approx(9.0 / stats.repeats)
        ref, _ = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=8,
                                 device="cpu").generate({"tokens": toks}, 4)
        np.testing.assert_array_equal(out, ref)

    def test_stats_sum_the_phases_without_a_call_window(self):
        st = GenStats(prefill_energy_j=1.5, decode_energy_j=2.0)
        assert st.energy_j == 3.5
        st.call_energy_j = 0.25
        assert st.energy_j == 0.25


class Recorder:
    """An engine stand-in recording every generate's tokens and length."""

    def __init__(self, vocab):
        self.cfg = types.SimpleNamespace(vocab_size=vocab, family="dense")
        self.calls = []

    def generate(self, batch, max_new):
        toks = np.asarray(batch["tokens"])
        self.calls.append((toks.copy(), max_new))
        tin = toks.shape[1]
        return None, types.SimpleNamespace(energy_j=0.3 * tin + 0.9 * max_new
                                           + 1e-3 * tin * max_new + 1e-4 * len(self.calls),
                                           runtime_s=1e-3 * tin + 4e-3 * max_new
                                           + 1e-6 * len(self.calls))


class TestWarmUp:
    def test_trials_draw_the_reference_campaigns_tokens(self, monkeypatch):
        """The port warms each engine once, over every length, and then its
        trials' tokens equal those the reference's campaign measures (its
        per-(τin, τout) warm-ups repeat a trial's own tokens)."""
        engines = {}

        def fake(pkg):
            def build_engine(arch, *, kv_cache, **kw):
                assert not kv_cache
                engines[pkg] = Recorder(32000)
                return engines[pkg]
            return build_engine

        monkeypatch.setattr(jserve, "build_engine", fake("ref"))
        monkeypatch.setattr(port_serve, "build_engine", fake("port"))
        jserve.characterize_fleet(["llama2-7b-reduced"], max_tokens=16)
        trials = port_serve.characterize("llama2-7b-reduced", max_tokens=16, device="cpu")

        ref = engines["ref"].calls
        warmed, measured = set(), []
        for toks, n in ref:
            key = (toks.shape[1], n)
            if key in warmed:
                measured.append((toks, n))
            else:
                warmed.add(key)
        assert len(measured) == len(ref) - len(warmed)
        port = engines["port"].calls
        (w_toks, w_new), trial_calls = port[0], port[1:]
        assert w_toks.shape == (2, 8) and w_new == 2 * 16     # lengths 8 .. 39
        assert len(trial_calls) == len(measured) == len(trials)
        for (a, na), (b, nb), t in zip(trial_calls, measured, trials):
            assert na == nb == t.tau_out and a.shape[1] == t.tau_in
            np.testing.assert_array_equal(a, b)

    def test_host_model_charges_the_modeled_power(self):
        trials = run_campaign(
            "m", lambda tin, tout: (5.0 * tin, 1e-3 * tin + 1e-2 * tout),
            port_serve.campaign_settings(16))
        modeled = port_serve.host_model(trials)
        power = WallClockMeter().power_w
        for t, m in zip(trials, modeled):
            assert m.energy_j == power * t.runtime_s
            assert (m.tau_in, m.tau_out, m.runtime_s) == (t.tau_in, t.tau_out, t.runtime_s)
