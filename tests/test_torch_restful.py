"""The port's per-tick REST serving (``RESTfulAPI`` with
``RestfulLoader``) and the REPL's ``InteractiveLoader``
(veles_tpu_torch/serving.py) against the JAX package's, on the CPU: the
cases of tests/test_serving.py's REST and interactive tests, each sent
to a port harness and a JAX harness, which must give the same replies
(status and body). The harness wires loader -> compute -> API by hand on
a background thread, as tests/test_serving.py:27-60 does."""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.core.config import root as jroot
from veles_tpu.dummy import DummyLauncher as JDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.models.mlp import MLPWorkflow as JMLPWorkflow
from veles_tpu.observe.history import stop_history_sampler as jstop_history
from veles_tpu.serving import InteractiveLoader as JInteractiveLoader
from veles_tpu.serving import RESTfulAPI as JRESTfulAPI
from veles_tpu.serving import RestfulLoader as JRestfulLoader
from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.base import loader_registry
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.parallel.fused import forward_chain
from veles_tpu_torch.serving import (InteractiveLoader, RESTfulAPI,
                                     RestfulLoader)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _stop_jax_history_sampler():
    """The JAX package's RESTfulAPI starts its metric-history sampler, a
    non-daemon thread, and no stop() releases it: stop it when this file
    is done, so it does not outlive the file in its worker."""
    yield
    jstop_history()


def _workflow(pkg):
    if pkg == "jax":
        return JDummyWorkflow()
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.numpy()
    return numpy.asarray(value)


class Harness:
    """loader -> compute(minibatch) -> api, looping on a thread."""

    def __init__(self, pkg, compute=None, mb=4, max_response_time=0.05,
                 sample_shape=(3,), derive=None, start=True, **api_kwargs):
        jax_side = pkg == "jax"
        wf = _workflow(pkg)
        loader_cls = JRestfulLoader if jax_side else RestfulLoader
        api_cls = JRESTfulAPI if jax_side else RESTfulAPI
        self.loader = loader_cls(wf, sample_shape=sample_shape,
                                 minibatch_size=mb,
                                 max_response_time=max_response_time)
        if derive is not None:
            self.loader.derive_from(derive)
        self.loader.initialize()
        self.api = api_cls(wf, port=0, path="/api", **api_kwargs)
        self.api.feed = self.loader.feed
        self.api.requests = []
        self.api.initialize()
        self.compute = compute or (lambda batch: batch * 2.0)
        self.ticks = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if start:
            self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.loader.run()
            if self.loader.complete:
                return
            self.api.results = self.compute(self.loader.minibatch_data.data)
            self.api.requests = self.loader.requests
            self.api.run()
            self.ticks += 1

    @property
    def url(self):
        return "http://127.0.0.1:%d/api" % self.api.port

    def close(self):
        self._stop.set()
        self.loader.stop()
        self.api.stop()
        if self._thread.is_alive():
            self._thread.join(timeout=10)


def post(url, payload, timeout=15):
    """(status, body) of one request; ``payload`` is a dict (sent as
    JSON) or raw bytes."""
    data = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        body = err.read().decode()
        try:
            body = json.loads(body)
        except ValueError:
            body = None
        return err.code, body, err.headers.get("Retry-After")


@pytest.fixture
def harnesses():
    made = []

    def make(**kwargs):
        pair = [Harness(pkg, **kwargs) for pkg in ("torch", "jax")]
        made.extend(pair)
        return pair
    yield make
    for harness in made:
        harness.close()


def _same(pair, payload):
    ours, theirs = (post(h.url, payload) for h in pair)
    assert ours == theirs
    return ours


REQUESTS = {
    "list": {"input": [1.0, 2.0, 3.0], "codec": "list"},
    "base64": {"input": base64.b64encode(numpy.array(
        [0.5, 1.5, 2.5], numpy.float32).tobytes()).decode(),
        "codec": "base64", "shape": [3], "type": "float32"},
    "base64_f64": {"input": base64.b64encode(numpy.array(
        [[1.0, -2.0, 4.0]]).tobytes()).decode(),
        "codec": "base64", "shape": [1, 3], "type": "float64"},
    "no_codec": {"input": [1, 2, 3]},
    "no_input": {"codec": "list"},
    "bogus_codec": {"input": "x", "codec": "bogus"},
    "base64_no_shape": {"input": "QUFB", "codec": "base64"},
    "base64_bad_bytes": {"input": "QUFB", "codec": "base64",
                         "shape": [3], "type": "float32"},
    "ragged": {"input": [[1], [2, 3]], "codec": "list"},
    "wrong_size": {"input": [1.0, 2.0], "codec": "list"},
    "not_a_dict": [1, 2, 3],
}
STATUS = {"list": 200, "base64": 200, "base64_f64": 200}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_replies_match_jax(harnesses, name):
    status = _same(harnesses(), REQUESTS[name])[0]
    assert status == STATUS.get(name, 400)


def test_codec_results(harnesses):
    pair = harnesses()
    assert _same(pair, REQUESTS["list"])[1] == {"result": [2.0, 4.0, 6.0]}
    assert _same(pair, REQUESTS["base64"])[1] == {
        "result": [1.0, 3.0, 5.0]}


def test_unparsable_body_gets_400(harnesses):
    assert _same(harnesses(), b"{not json")[0] == 400


def test_concurrent_requests_batched(harnesses):
    pair = harnesses(max_response_time=0.2)
    for harness in pair:
        results = {}

        def call(i, url=harness.url):
            results[i] = post(url, {"input": [float(i)] * 3,
                                    "codec": "list"})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert not any(t.is_alive() for t in threads)
        for i in range(3):
            assert results[i] == (200, {"result": [2.0 * i] * 3})
        # three requests inside one flush window share a tick
        assert harness.ticks < 3


def test_zero_max_response_time_still_flushes(harnesses):
    pair = harnesses(max_response_time=0)
    assert _same(pair, {"input": [1.0, 1.0, 1.0], "codec": "list"}) == (
        200, {"result": [2.0, 2.0, 2.0]})


def test_body_over_max_body_gets_413(harnesses):
    pair = harnesses(max_body=64)
    big = {"input": [1.0] * 100, "codec": "list"}
    ours, theirs = (post(h.url, big) for h in pair)
    assert ours[0] == theirs[0] == 413


def test_full_batch_gets_429_with_retry_after():
    """With no tick running, the minibatch fills up; the next request is
    shed with 429 and a Retry-After, in both packages."""
    for pkg in ("torch", "jax"):
        harness = Harness(pkg, mb=2, start=False)
        try:
            for _ in range(2):
                harness.loader.feed(numpy.zeros(3), {})
            reply = post(harness.url, REQUESTS["list"])
            assert reply == (429, {"error": "server saturated: retry"},
                             "1")
            counters = harness.api.health.snapshot()["counters"]
            assert counters["rejected"] == 1 and counters["admitted"] == 0
        finally:
            harness.close()


def test_not_ready_gets_503_and_health_routes(harnesses):
    pair = harnesses()
    for harness in pair:
        base = harness.url[:-len("/api")]
        with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
            assert json.loads(resp.read().decode())["ready"] is True
        with urllib.request.urlopen(base + "/readyz", timeout=5) as resp:
            assert resp.status == 200
        harness.api.health.set_ready(False)
    ours, theirs = (post(h.url, REQUESTS["list"]) for h in pair)
    assert ours == theirs == (503, {"error": "not ready"}, "1")
    for harness in pair:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(harness.url[:-len("/api")] + "/nope",
                                   timeout=5)
        assert err.value.code == 404


def test_units_pickle_and_the_server_takes_a_burst():
    """Both units pickle (their locks and events are volatile and
    rebuilt), and the server's listen backlog holds a burst of
    concurrent clients (socketserver's default of 5 reset them)."""
    import pickle
    harness = Harness("torch")
    try:
        assert harness.api._httpd_.request_queue_size >= 64
        loader = pickle.loads(pickle.dumps(harness.loader))
        assert loader.sample_shape == (3,) and not loader.requests
        assert loader._staged_requests_ == []
        api = pickle.loads(pickle.dumps(harness.api))
        assert not api.health.ready and api._httpd_ is None
    finally:
        harness.close()


def test_restful_loader_registered_and_checks_its_shape():
    assert loader_registry["restful"] is RestfulLoader
    assert loader_registry["interactive"] is InteractiveLoader
    with pytest.raises(ValueError):
        RestfulLoader(_workflow("torch"), max_response_time=-1)
    loader = RestfulLoader(_workflow("torch"))
    with pytest.raises(ValueError, match="derive_from"):
        loader.initialize()


def _digits_pair():
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = digits.data.astype(numpy.float32)
    y = digits.target.astype(numpy.int32)
    kwargs = dict(layers=(16, 10),
                  loader_kwargs=dict(data=x, labels=y,
                                     class_lengths=[0, 297, 1500],
                                     minibatch_size=100,
                                     normalization_type="mean_disp"),
                  max_epochs=1, name="served")
    jprng.get("default").seed(2)
    jwf = JMLPWorkflow(JDummyLauncher(), **kwargs)
    jwf.initialize()
    twf = MLPWorkflow(DummyLauncher(), device="cpu", **kwargs)
    unit_params_from_jax(twf, [
        {"weights": numpy.asarray(f.weights.data),
         "bias": numpy.asarray(f.bias.data)} for f in jwf.forwards])
    twf.initialize()
    return jwf, twf, x


def test_serves_the_trained_forward_chain_as_jax(harnesses, monkeypatch):
    """``derive_from`` adopts the trained loader's sample shape and
    normalizer; each tick runs the trained forward chain (the port:
    ``fused.forward_chain``; JAX: the forward units' own ``compute``,
    each unit's ``output``, the head's logits included). The same
    samples get the same answers within f32 round-off."""
    for engine in (root.common.engine, jroot.common.engine):
        monkeypatch.setattr(engine, "precision_level", 2)
    jwf, twf, x = _digits_pair()

    def jax_forward(batch):
        for unit in jwf.forwards:
            batch = unit.compute(batch, unit.weights.data, unit.bias.data)
            if isinstance(batch, tuple):  # the head's (output, max_idx)
                batch = batch[0]
        return batch

    ours = Harness("torch", compute=forward_chain(twf), mb=8,
                   derive=twf.loader, sample_shape=())
    theirs = Harness("jax", compute=jax_forward, mb=8, derive=jwf.loader,
                     sample_shape=())
    try:
        assert ours.loader.sample_shape == theirs.loader.sample_shape \
            == (64,)
        for row in (0, 5, 1000):
            payload = {"input": x[row].tolist(), "codec": "list"}
            got, want = post(ours.url, payload), post(theirs.url, payload)
            assert got[0] == want[0] == 200
            numpy.testing.assert_allclose(got[1]["result"],
                                          want[1]["result"], rtol=0,
                                          atol=1e-5)
    finally:
        ours.close()
        theirs.close()


class TestInteractiveLoader:
    def test_feed_and_complete(self):
        for pkg, cls in (("torch", InteractiveLoader),
                         ("jax", JInteractiveLoader)):
            loader = cls(_workflow(pkg), sample_shape=(4,))
            loader.initialize()
            served = []

            def run_once(loader=loader, served=served):
                loader.run()
                served.append(_host(loader.minibatch_data.data).copy())

            t = threading.Thread(target=run_once)
            t.start()
            loader.feed(numpy.arange(4.0))
            t.join(timeout=10)
            assert not t.is_alive()
            numpy.testing.assert_array_equal(served[0][0],
                                             [0.0, 1.0, 2.0, 3.0])
            loader.feed(None)
            assert bool(loader.complete)

    @pytest.mark.parametrize("form", ["npy", "npz", "txt"])
    def test_feed_from_file(self, tmp_path, form):
        path = str(tmp_path / ("x." + form))
        value = numpy.arange(4, dtype=numpy.float32) / 2
        if form == "npy":
            numpy.save(path, value)
        elif form == "npz":
            numpy.savez(path, value)
        else:
            numpy.savetxt(path, value)
        for pkg, cls in (("torch", InteractiveLoader),
                         ("jax", JInteractiveLoader)):
            loader = cls(_workflow(pkg), sample_shape=(4,))
            loader.initialize()
            t = threading.Thread(target=loader.run)
            t.start()
            loader.feed(path)
            t.join(timeout=10)
            assert not t.is_alive()
            numpy.testing.assert_array_equal(
                _host(loader.minibatch_data.data)[0], value)
