"""The port's meta-workflows (veles_tpu_torch/genetics/, ensemble/, the
GeneticExample sample and the ``--optimize*`` / ``--ensemble-*`` flags)
against the JAX package's on the CPU.

Mirrors tests/test_meta_workflows.py: ``TestGrayCodec``,
``TestGrayPopulation`` (populations drawn from the same seed evolve equal,
value for value, in every representation, crossover and mutation),
``TestTaskFarm`` (a loopback over the port's fleet protocol, and a dropped
slave's requeue) and ``TestEnsembleCombiner``. Then ``python -m
veles_tpu_torch --device cpu`` runs ``--optimize 4:2`` and
``--ensemble-train 3:0.8`` / ``--ensemble-test`` on a tiny MLP, both
started at once by one fixture: the GA's generations must be what the JAX
package's ``Population`` makes from the same seed and the same fitnesses,
and each instance's dumped outputs must read back through both packages'
``EnsembleLoader`` bit for bit."""

import json
import os
import subprocess
import sys
import threading

import numpy
import pytest
import torch

from veles_tpu.core import prng as jprng
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
from veles_tpu.ensemble import EnsembleLoader as JEnsembleLoader
from veles_tpu.ensemble import OutputDumper as JOutputDumper
from veles_tpu.genetics.config import Range as JRange
from veles_tpu.genetics.core import GrayCodec as JGrayCodec
from veles_tpu.genetics.core import Population as JPopulation
from veles_tpu.genetics.core import gray_decode as jgray_decode
from veles_tpu.genetics.core import gray_encode as jgray_encode
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import Config
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.ensemble import (EnsembleLoader, OutputDumper,
                                      build_combiner_file)
from veles_tpu_torch.genetics import Range, fix_config, process_config
from veles_tpu_torch.genetics.core import (GrayCodec, Population,
                                           gray_decode, gray_encode)
from veles_tpu_torch.loader.base import TRAIN, VALID

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240


def genes(rng_cls=Range):
    return [("root.lr", rng_cls(0.5, 0.0, 1.0)),
            ("root.units", rng_cls(8, 2, 30))]


def _cpu_workflow():
    wf = DummyWorkflow()
    wf.device = torch.device("cpu")
    return wf


class TestGrayCodec:
    def test_gray_identities_match_jax(self):
        for n in range(1024):
            assert gray_encode(n) == jgray_encode(n)
            assert gray_decode(gray_encode(n)) == n == jgray_decode(
                jgray_encode(n))
        for n in range(63):
            diff = gray_encode(n) ^ gray_encode(n + 1)
            assert bin(diff).count("1") == 1

    @pytest.mark.parametrize("accuracy", [10, 1000])
    def test_codec_matches_jax(self, accuracy):
        codec, jcodec = GrayCodec(genes(), accuracy), JGrayCodec(
            genes(JRange), accuracy)
        assert codec.widths == jcodec.widths
        rng = numpy.random.RandomState(accuracy)
        for _ in range(50):
            values = [float(rng.rand()), int(rng.randint(2, 31))]
            bits = codec.encode(values)
            assert bits == jcodec.encode(values)
            assert codec.decode(bits) == jcodec.decode(bits)
            assert abs(codec.decode(bits)[0] - values[0]) <= 1.0 / accuracy
        ones = [1] * codec.total_bits
        decoded = codec.decode(ones)
        assert decoded == jcodec.decode(ones)
        assert 0.0 <= decoded[0] <= 1.0 and 2 <= decoded[1] <= 30


def test_host_stream_draws_as_jax():
    """The draws the GA takes from a named stream (``random_sample``,
    ``randint``, ``normal``, ``permutation``, ``fill``) come from the same
    PCG64 generator as the JAX package's: equal draw for draw, in any
    interleaving, from the same seed."""
    key = "test-host-stream"
    streams = (prng.get(key).seed(123), jprng.get(key).seed(123))
    got = []
    for rg in streams:
        arr = numpy.zeros((3, 4))
        rg.fill(arr, -2.0, 5.0)
        got.append([rg.random_sample(), rg.random_sample(5).tolist(),
                    int(rg.randint(0, 10)), rg.normal(0, 0.3),
                    rg.permutation(7).tolist(), arr.tolist(),
                    rg.permutation(numpy.arange(4) * 2).tolist()])
    assert got[0] == got[1]


def _fitness(values):
    """A deterministic fitness of a member: prefer lr near 0.7 and few
    units (both packages' members get the same)."""
    return -abs(values[0] - 0.7) - 0.01 * values[1]


def _evolve_both(key, seed, generations=4, **kwargs):
    """Both packages' populations from one seed of stream ``key``: their
    members' values at each generation, and the port's population."""
    jprng.get(key).seed(seed)
    prng.get(key).seed(seed)
    theirs = JPopulation(genes(JRange), prng_key=key, **kwargs)
    ours = Population(genes(), prng_key=key, **kwargs)
    walks = []
    for pop in (theirs, ours):
        walk = [[list(m.values) for m in pop.members]]
        for _ in range(generations):
            for member in pop.members:
                member.fitness = _fitness(member.values)
            pop.evolve()
            walk.append([list(m.values) for m in pop.members])
        walks.append(walk)
    return walks, ours


NUMERIC = [(c, m) for c in ("uniform", "one_point", "two_point",
                            "arithmetic", "geometric")
           for m in ("gaussian", "uniform", "altering")]
GRAY = [(c, "binary_point") for c in ("uniform", "one_point", "two_point",
                                      "arithmetic", "geometric")]


class TestGrayPopulation:
    @pytest.mark.parametrize("representation,crossover,mutation",
                             [("numeric",) + case for case in NUMERIC]
                             + [("gray",) + case for case in GRAY])
    def test_evolves_as_jax(self, representation, crossover, mutation):
        (theirs, ours), pop = _evolve_both(
            "test-ga-%s-%s-%s" % (representation, crossover, mutation),
            17, size=8, crossover=crossover, mutation=mutation,
            mutation_rate=0.3, representation=representation,
            accuracy=100)
        assert ours == theirs
        # "altering" swaps two genes' values, ranges apart, in both
        # packages: each swapped value is clipped to its new gene's range
        # only where a later mutation or crossover clips it
        for members in ours if mutation != "altering" else ():
            for values in members:
                assert 0.0 <= values[0] <= 1.0 and 2 <= values[1] <= 30
                assert isinstance(values[1], int)
        assert pop.generation == 4 and pop.best is None  # not evaluated

    def test_gray_defaults_to_binary_point(self):
        pop = Population(genes(), size=4, representation="gray",
                         crossover="two_point", prng_key="test-ga-default")
        assert pop.mutation_type == "binary_point"
        with pytest.raises(ValueError, match="numeric' or 'gray"):
            Population(genes(), representation="binary")
        numeric = Population(genes(), size=4, mutation="binary_point",
                             prng_key="test-ga-default")
        with pytest.raises(ValueError, match="binary_point"):
            numeric.mutate(numeric.members[0])

    def test_config_genes_and_fix(self):
        tree = Config("root")
        tree.lr = Range(0.1, 0.01, 1.0)
        tree.sub = Config("root.sub")
        tree.sub.units = Range(8, 2, 30)
        tree.sub.plain = 3
        got = process_config(tree)
        assert [(path, (r.default, r.min_value, r.max_value))
                for path, r in got] == [
            ("root.lr", (0.1, 0.01, 1.0)),
            ("root.sub.units", (8, 2, 30))]
        assert got[1][1].is_integer and not got[0][1].is_integer
        assert got[1][1].clip(31.6) == 30 and got[0][1].clip(-1) == 0.01
        fix_config(tree)
        assert (tree.lr, tree.sub.units, tree.sub.plain) == (0.1, 8, 3)
        with pytest.raises(TypeError):
            Range(1)


class TestTaskFarm:
    def test_loopback_over_fleet_protocol(self):
        """Shell tasks through the port's fleet server and a farm worker
        (reference optimization_workflow.py:179-279), two batches."""
        from veles_tpu_torch.fleet.farm import TaskFarmMaster, farm_worker
        from veles_tpu_torch.fleet.server import Server

        farm = TaskFarmMaster("test")
        server = Server("127.0.0.1:0", farm).start()
        farm.on_new_tasks = server.kick
        worker = threading.Thread(
            target=farm_worker,
            args=("127.0.0.1:%d" % server.port, "test"), daemon=True)
        worker.start()
        code = ("import json,sys;"
                "argv=sys.argv;"
                "path=argv[argv.index('--result-file')+1];"
                "json.dump({'value': int(argv[1])}, open(path,'w'))")
        try:
            for i in range(3):
                farm.submit("t%d" % i, [sys.executable, "-c", code, str(i)])
            results = farm.wait_batch(timeout=60)
            assert {k: v["results"]["value"]
                    for k, v in results.items()} == \
                {"t0": 0, "t1": 1, "t2": 2}
            farm.take_results()
            farm.submit("t3", [sys.executable, "-c", code, "7"])
            results = farm.wait_batch(timeout=60)
            assert results["t3"]["results"]["value"] == 7
            farm.close()
            server.kick()
            worker.join(timeout=10)
            assert not worker.is_alive()
        finally:
            server.stop()

    def test_drop_slave_requeues(self):
        from veles_tpu_torch.fleet.farm import TaskFarmMaster

        class Slave:
            id = "s1"

        farm = TaskFarmMaster("x")
        farm.submit("a", ["cmd"])
        job = farm.generate_data_for_slave(Slave())
        assert job["task_id"] == "a"
        assert farm.generate_data_for_slave(Slave()) is False
        farm.drop_slave(Slave())
        assert farm.generate_data_for_slave(Slave())["task_id"] == "a"

    def test_optimizer_evaluates_through_the_farm(self):
        """``--optimize-fleet``: a generation's evaluations become farm
        jobs of ``python -m veles_tpu_torch`` commands (the device passed
        through); a fleet slave's results set the fitnesses."""
        from veles_tpu_torch.genetics import GeneticsOptimizer

        prng.get("genetics").seed(5)
        opt = GeneticsOptimizer("wf.py", "cfg.py", genes=genes(),
                                population_size=3, generations=1,
                                seed=9, fleet="127.0.0.1:0", device="cpu",
                                overrides=["root.x=1"])
        submitted = []
        farm = opt._farm
        try:
            def submit(task_id, argv):
                submitted.append((task_id, argv))
            farm.submit = submit
            farm.wait_batch = lambda timeout=None: {
                task_id: ({"rc": 0, "results": {
                    "best_validation_errors": n}} if n else {"rc": 1})
                for n, (task_id, _) in enumerate(submitted)}
            opt._evaluate_fleet()
        finally:
            opt._farm_server.stop()
        assert [task for task, _ in submitted] == ["gen0-0", "gen0-1",
                                                   "gen0-2"]
        argv = submitted[1][1]
        assert argv[1:5] == ["-m", "veles_tpu_torch", "wf.py", "cfg.py"]
        assert argv[5] == "root.x=1" and argv[6].startswith("root.lr=")
        assert argv[-4:] == ["--seed", "9", "--device", "cpu"]
        assert [m.fitness for m in opt.population.members] == [-1e30,
                                                               -1.0, -2.0]


class TestEnsembleCombiner:
    def _entries(self, dumper_cls, wf_fn, outputs, klass):
        entries = []
        for mid, out in enumerate(outputs):
            dumper = dumper_cls(wf_fn(), model_id="m%d" % mid, klass=klass)
            for start in range(0, len(out), 10):
                dumper.output = out[start:start + 10]
                dumper.minibatch_indices = numpy.arange(start, start + 10)
                dumper.minibatch_valid_size = 10
                dumper.minibatch_class = klass
                dumper.run()
                # another class's minibatch is not recorded
                dumper.minibatch_class = 1 - klass if klass < 2 else 0
                dumper.run()
            entries.append(dumper.entry(labels=["a", "b", "c"]))
        return entries

    def test_output_dumper_and_loader_as_jax(self, tmp_path):
        rng = numpy.random.RandomState(0)
        n, dim = 30, 3
        winners = rng.randint(0, dim, n)
        outputs = []
        for _ in range(2):
            out = rng.rand(n, dim).astype(numpy.float32)
            out[numpy.arange(n), winners] += 2.0
            outputs.append(out)
        ours = self._entries(OutputDumper, _cpu_workflow,
                             [torch.from_numpy(o) for o in outputs], TRAIN)
        theirs = self._entries(JOutputDumper, JDummyWorkflow, outputs,
                               TRAIN)
        assert ours == theirs
        path = build_combiner_file(
            ours, [["a", "b", "c"][w] for w in winners],
            str(tmp_path / "models.json"))
        loader = EnsembleLoader(_cpu_workflow(), file=path,
                                minibatch_size=10)
        loader.initialize()
        jloader = JEnsembleLoader(JDummyWorkflow(), file=path,
                                  minibatch_size=10)
        jloader.initialize()
        assert loader.class_lengths == jloader.class_lengths == [0, 0, n]
        data = loader.original_data.data.numpy()
        assert data.shape == (n, 2, dim)
        numpy.testing.assert_array_equal(
            data, numpy.asarray(jloader.original_data.data))
        numpy.testing.assert_array_equal(data, numpy.stack(outputs, 1))
        numpy.testing.assert_array_equal(
            loader.original_labels.data.numpy(), winners)

    def test_loader_remaps_label_order_and_tests(self, tmp_path):
        rng = numpy.random.RandomState(2)
        out = rng.rand(6, 3).astype(numpy.float32)
        entries = [{"id": "a", "Output": out.tolist(),
                    "Labels": ["x", "y", "z"]},
                   {"id": "b", "Output": out[:, [2, 0, 1]].tolist(),
                    "Labels": ["z", "x", "y"]}]
        path = build_combiner_file(entries, ["y"] * 6,
                                   str(tmp_path / "m.json"))
        for testing in (False, True):
            loader = EnsembleLoader(_cpu_workflow(), file=path,
                                    testing=testing, minibatch_size=3)
            loader.initialize()
            jloader = JEnsembleLoader(JDummyWorkflow(), file=path,
                                      testing=testing, minibatch_size=3)
            jloader.initialize()
            data = loader.original_data.data.numpy()
            numpy.testing.assert_array_equal(
                data, numpy.asarray(jloader.original_data.data))
            numpy.testing.assert_array_equal(data[:, 0], data[:, 1])
            assert loader.class_lengths == jloader.class_lengths == (
                [6, 0, 0] if testing else [0, 0, 6])
        bad = build_combiner_file([entries[0], {"id": "c", "Output": [[0]]}],
                                  [], str(tmp_path / "bad.json"))
        with pytest.raises(ValueError, match="output shape"):
            EnsembleLoader(_cpu_workflow(), file=bad,
                           minibatch_size=1).initialize()

    def test_output_dumper_wired_into_workflow(self):
        """wire() puts the dumper in the control chain (evaluator ->
        dumper -> decision), so it records the validation rows of its own
        class in graph mode."""
        from veles_tpu_torch.models.mlp import MLPWorkflow

        rng = numpy.random.RandomState(0)
        x = rng.rand(300, 8).astype(numpy.float32)
        y = (x[:, 0] > 0.5).astype(numpy.int32)
        wf = MLPWorkflow(
            DummyLauncher(), layers=(8, 2), device="cpu",
            loader_kwargs=dict(data=x, labels=y,
                               class_lengths=[0, 100, 200],
                               minibatch_size=50),
            learning_rate=0.2, max_epochs=3, fused=False, name="dump-wf")
        dumper = OutputDumper(wf, model_id="m", klass=VALID).wire(wf)
        wf.initialize()
        wf.run()
        assert sorted(dumper.rows) == list(range(100))
        entry = dumper.entry()
        assert len(entry["Output"]) == 100 and len(entry["Output"][0]) == 2

    def test_combiner_model_trains_on_stack(self, tmp_path):
        """Member outputs -> EnsembleLoader -> a combiner MLP that learns
        the vote (the reference's stacking pipeline)."""
        from veles_tpu_torch.models.standard import StandardWorkflow

        prng.get("default").seed(4)
        prng.get("loader").seed(5)
        rng = numpy.random.RandomState(1)
        n, dim = 120, 4
        winners = rng.randint(0, dim, n)
        entries = []
        for mid in range(3):
            outputs = rng.rand(n, dim).astype(numpy.float32) * 0.3
            good = rng.rand(n) < 0.8
            outputs[numpy.arange(n)[good], winners[good]] += 1.0
            entries.append({"id": "m%d" % mid, "Output": outputs.tolist(),
                            "Labels": []})
        path = build_combiner_file(entries, winners.tolist(),
                                   str(tmp_path / "models.json"))
        wf = StandardWorkflow(
            DummyLauncher(), device="cpu", loader_cls=EnsembleLoader,
            loader_kwargs=dict(file=path, minibatch_size=20,
                               validation_ratio=0.25),
            layers=[{"type": "all2all_tanh", "output_sample_shape": 16},
                    {"type": "softmax", "output_sample_shape": dim}],
            learning_rate=0.1, decision_kwargs=dict(max_epochs=8),
            name="combiner")
        wf.initialize()
        wf.run()
        best = wf.decision.best_n_err[VALID]
        assert best is not None and best <= 10, \
            "combiner at %s/30 validation errors" % best


# -- the command line ----------------------------------------------------------

#: the tiny MLP every meta-workflow child runs: its learning rate and
#: momentum are the GA's genes; an ensemble instance snapshots its best
#: epoch, and an --ensemble-test child (a -w resume) dumps its validation
#: outputs from the snapshot's weights before its one more epoch
META_WF = '''
import json, os
import numpy
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.ensemble import OutputDumper
from veles_tpu_torch.loader.base import TEST, VALID
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.snapshotter import Snapshotter

root.meta.update({"epochs": 2, "out": None, "learning_rate": 0.3,
                  "gradient_moment": 0.0})


def dump(wf, path):
    loader = wf.loader
    dumper = OutputDumper(DummyWorkflow(), model_id=path, klass=VALID)
    start = loader.class_lengths[TEST]
    stop = start + loader.class_lengths[VALID]
    loader.minibatch_class = VALID
    for first in range(start, stop, loader.max_minibatch_size):
        index = numpy.arange(first, min(first + loader.max_minibatch_size,
                                        stop))
        loader.fill_minibatch(index, len(index))
        x = loader.minibatch_data.data
        for unit in wf.forwards:
            x = unit.compute(x, unit.weights.data, unit.bias.data)
            x = x[0] if isinstance(x, tuple) else x
        dumper.output, dumper.minibatch_indices = x, index
        dumper.minibatch_valid_size, dumper.minibatch_class = len(index), \\
            VALID
        dumper.run()
    with open(path, "w") as fout:
        json.dump(dumper.entry(), fout)


def run(load, main):
    cfg = root.meta
    rng = numpy.random.RandomState(0)
    x = rng.rand(160, 6).astype(numpy.float32)
    y = (x[:, 0] + x[:, 1] > 1.0).astype(numpy.int32)
    wf, resumed = load(MLPWorkflow, layers=(8, 2),
                       loader_kwargs=dict(data=x, labels=y,
                                          class_lengths=[0, 40, 120],
                                          minibatch_size=20),
                       learning_rate=cfg.learning_rate,
                       gradient_moment=cfg.gradient_moment,
                       max_epochs=cfg.epochs, name="meta")
    tag = "%d" % os.getpid()
    if resumed:
        dump(wf, os.path.join(cfg.out, "outputs-%s.json" % tag))
        wf.decision.complete.unset()
        wf.decision.train_ended.unset()
    else:
        snap = Snapshotter(wf, directory=cfg.out, prefix="meta-" + tag,
                           compression="", interval=1, time_interval=0)
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.decision.improved
        wf.end_point.unlink_from(wf.decision)
        wf.end_point.link_from(snap)
        wf.snapshotter = snap
    main()
'''

META_CONFIG = '''
from veles_tpu_torch.genetics import Range

root.meta.update({
    "learning_rate": Range(0.3, 0.05, 0.6),
    "gradient_moment": Range(0.5, 0.0, 0.9),
})
'''


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``--optimize 4:2`` (stream "genetics" seeded 11) and
    ``--ensemble-train 3:0.8`` (stream "ensemble" seeded 12) started at
    once, then ``--ensemble-test`` of the ensemble beside the
    GeneticExample sample's ``--optimize 4:1`` (at most four children at
    a time: the file shares its host with other workers); each is
    ``(returncode, stdout, stderr, directory)``."""
    out = {}
    procs = {}
    base = [sys.executable, "-m", "veles_tpu_torch"]
    samples = os.path.join(REPO, "veles_tpu_torch", "samples")

    def start(name, argv, directory):
        procs[name] = (subprocess.Popen(
            base + argv, cwd=directory, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), directory)

    for name, flags in (
            ("optimize", ["--optimize", "4:2", "--seed",
                          "genetics=11,default=3,loader=4"]),
            ("ensemble_train", ["--ensemble-train", "3:0.8", "--seed",
                                "ensemble=12,default=3,loader=4"])):
        directory = str(tmp_path_factory.mktemp(name))
        for fname, text in (("meta_wf.py", META_WF),
                            ("meta_config.py", META_CONFIG)):
            with open(os.path.join(directory, fname), "w") as fout:
                fout.write(text)
        start(name, ["meta_wf.py", "meta_config.py",
                     "root.meta.out=%r" % directory, "--device", "cpu"]
              + flags, directory)

    def finish(name):
        proc, directory = procs[name]
        try:
            stdout, stderr = proc.communicate(timeout=DEADLINE)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out[name] = (proc.returncode, stdout, stderr, directory)
    finish("ensemble_train")
    directory = procs["ensemble_train"][1]
    start("ensemble_test", ["meta_wf.py", "meta_config.py",
                            "root.meta.out=%r" % directory, "--device",
                            "cpu", "--ensemble-test", "ensemble.json"],
          directory)
    finish("optimize")
    start("genetic_example", [
        os.path.join(samples, "genetic_example.py"),
        os.path.join(samples, "genetic_config.py"), "--optimize", "4:1",
        "--device", "cpu", "--seed", "genetics=2"],
        str(tmp_path_factory.mktemp("genetic_example")))
    for name in ("ensemble_test", "genetic_example"):
        finish(name)
    return out


def _ok(run):
    code, stdout, stderr, _ = run
    assert code == 0, stderr[-3000:]
    return stdout


def test_optimize_generations_replay_as_jax(runs):
    """The GA's two generations of four: every child exited 0 (its
    fitness is -best_validation_errors, a count), and the populations are
    what the JAX package's Population makes from the same seed given the
    same fitnesses, value for value."""
    got = json.loads(_ok(runs["optimize"]))
    pops = got["populations"]
    assert len(pops) == 2 and all(len(p) == 4 for p in pops)
    fits = [f for pop in pops for _, f in pop]
    assert all(f <= 0 and f == int(f) for f in fits), fits
    assert got["best_fitness"] == max(pops[0] + pops[1],
                                      key=lambda m: m[1])[1]
    assert got["history"] == [max(f for _, f in pop) for pop in pops] \
        or got["history"][1] >= got["history"][0]
    jprng.get("genetics").seed(11)
    theirs = JPopulation([("root.meta.learning_rate",
                           JRange(0.3, 0.05, 0.6)),
                          ("root.meta.gradient_moment",
                           JRange(0.5, 0.0, 0.9))], size=4)
    for generation, pop in enumerate(pops):
        assert [m.values for m in theirs.members] == [v for v, _ in pop]
        for member, (_, fitness) in zip(theirs.members, pop):
            member.fitness = fitness
        if generation == 0:
            theirs.evolve()
    # the defaults seed the first member, as in the JAX package
    assert pops[0][0][0] == [0.3, 0.5]
    best = {path.split(".")[-1]: value
            for path, value in got["best_values"].items()}
    assert set(best) == {"learning_rate", "gradient_moment"}


def test_ensemble_train_then_test(runs):
    """Three instances train (each a child with its seed and the 0.8
    train ratio, snapshotting), ensemble.json lists them; the test pass
    re-runs each snapshot, and each instance's dumped validation outputs
    read back through both packages' EnsembleLoader bit for bit."""
    _ok(runs["ensemble_train"])
    directory = runs["ensemble_train"][3]
    with open(os.path.join(directory, "ensemble.json")) as fin:
        ensemble = json.load(fin)
    assert ensemble["train_ratio"] == 0.8
    instances = ensemble["instances"]
    assert [e["index"] for e in instances] == [0, 1, 2]
    assert all(e["returncode"] == 0 for e in instances)
    assert len({e["seed"] for e in instances}) == 3
    jprng.get("ensemble").seed(12)
    assert [e["seed"] for e in instances] == [
        int(jprng.get("ensemble").randint(1, 2 ** 31)) for _ in range(3)]
    for entry in instances:
        assert os.path.isfile(entry["results"]["Snapshot"])
    tests = json.loads(_ok(runs["ensemble_test"]))["tests"]
    assert [t["returncode"] for t in tests] == [0, 0, 0]
    dumped = sorted(name for name in os.listdir(directory)
                    if name.startswith("outputs-"))
    assert len(dumped) == 3
    entries = []
    for name in dumped:
        with open(os.path.join(directory, name)) as fin:
            entries.append(json.load(fin))
    for entry in entries:
        assert len(entry["Output"]) == 40 and len(entry["Output"][0]) == 2
    path = build_combiner_file(entries, [0] * 40,
                               os.path.join(directory, "models.json"))
    want = numpy.stack([numpy.asarray(e["Output"], numpy.float32)
                        for e in entries], axis=1)
    loader = EnsembleLoader(_cpu_workflow(), file=path, minibatch_size=10)
    loader.initialize()
    jloader = JEnsembleLoader(JDummyWorkflow(), file=path,
                              minibatch_size=10)
    jloader.initialize()
    numpy.testing.assert_array_equal(loader.original_data.data.numpy(),
                                     want)
    numpy.testing.assert_array_equal(
        numpy.asarray(jloader.original_data.data), want)
    # the members differ: three seeds, three models
    assert not numpy.array_equal(want[:, 0], want[:, 1])


def test_genetic_example_sample_optimizes(runs):
    """The port's GeneticExample: --optimize 4:1 over its two Range knobs
    exits 0 with each member's EvaluationFitness in (0, 1]."""
    got = json.loads(_ok(runs["genetic_example"]))
    assert set(got["best_values"]) == {"root.test.x", "root.test.y"}
    fits = [f for _, f in got["populations"][0]]
    assert all(0 < f <= 1 for f in fits) and got["best_fitness"] == max(
        fits)
