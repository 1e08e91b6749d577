"""Population run modes (the JAX package's ``population.engine``).

* **standalone** — the master and an in-process worker in a
  self-driven loopback (no sockets): the member-job and fold cycle the
  fleet runs;
* **coordinator** (``-l``) — a :class:`PopulationMaster` served by a
  :class:`~veles_tpu_torch.server.Server` (``root.common.net.zero`` is
  raised to at least 1, so optimizer slots ride each member's delta
  plane);
* **worker** (``-m``) — a :class:`PopulationWorker` runs member jobs in
  a :class:`~veles_tpu_torch.client.Client`'s loop.

The GA mode takes the on-device vmap sub-population backend
(:mod:`.vmap_backend`) when every tune is a GD hyperparameter and
``root.common.population.vmap`` is not off (``--population-vmap off``
forces lineages) — one vmapped device job per generation — except on a
coordinator, which always runs fleet lineages.  Runs go to the device
the command line names (``--device``; the CUDA card by default).
"""

from ..config import root, get as config_get
from ..error import Bug
from ..harness import seed_to_int
from ..json_encoders import dump_json
from ..logger import Logger


def loopback_proto(ticks=1):
    """The protocol the standalone loopback uses: the delta dialect
    with slot sync (zero=1), what a population handshake negotiates
    with the default config."""
    return {"tensor": True, "delta": True, "codec": "none",
            "dtype": "fp32", "ticks": max(1, int(ticks)),
            "zero": 1, "zero_rank": 0}


class PopulationEngine(Logger):
    """Drives a population run in the mode the command line chose."""

    def __init__(self, main, size, mode=None, **kwargs):
        super(PopulationEngine, self).__init__()
        self.main = main
        self.module = main.module
        args = main.args
        self.listen_address = getattr(args, "listen_address", None)
        self.master_address = getattr(args, "master_address", None)
        self.result_file = args.result_file
        self.device = getattr(args, "device", "cuda")
        self.seed = seed_to_int(args.random_seed)
        self.size = int(size)
        self.generations = kwargs.pop("generations", None)
        self.kwargs = kwargs
        self.mode = mode or self._auto_mode()
        self.master = None
        #: The coordinator's server, once it listens (its ``port``).
        self.server = None

    def _auto_mode(self):
        """pbt when --pbt asked for it, ga when the config carries Tune
        leaves, plain member training otherwise."""
        if getattr(self.main.args, "pbt", False):
            return "pbt"
        from ..genetics.core import collect_tunes
        return "ga" if collect_tunes(root) else "train"

    # -- modes -------------------------------------------------------------

    def run(self):
        if self.master_address:
            self._run_worker()
            return None
        # A coordinator always runs fleet lineages: the vmap shortcut
        # would never bind the server its workers dial.
        if self.mode == "ga" and not self.listen_address and \
                self._vmap_backend_applicable():
            best = self._run_ga_vmap()
        else:
            if self.listen_address:
                self._run_coordinator()
            else:
                self._run_standalone()
            best = self.master.best
        self._finish(best)
        return best

    def _build_master(self):
        from ..launcher import Launcher
        from .master import PopulationMaster
        self.master = PopulationMaster(
            Launcher(), self.module, mode=self.mode, size=self.size,
            seed=self.seed, generations=self.generations,
            device=self.device, **self.kwargs)
        return self.master

    def _run_coordinator(self):
        from ..server import Server
        # Optimizer slots ride the per-member delta plane: slots kept
        # on a worker would leak one member's momentum into another's.
        if not int(config_get(root.common.net.zero, 0) or 0):
            root.common.net.zero = 1
        master = self._build_master()
        server = self.server = Server(self.listen_address, master)
        try:
            server.wait()
        finally:
            server.stop()
            server.join(timeout=10.0)
        if server.failure is not None:
            raise server.failure

    def _run_worker(self):
        from ..client import Client
        from ..launcher import Launcher
        from .worker import PopulationWorker
        worker = PopulationWorker(Launcher(), self.module,
                                  seed=self.seed, device=self.device)
        Client(self.master_address, worker).run()

    def _run_standalone(self, max_cycles=1000000):
        """The self-driven loopback: the master serves an in-process
        worker over the member-job contract the fleet uses."""
        from ..launcher import Launcher
        from .worker import PopulationWorker
        master = self._build_master()
        worker = PopulationWorker(Launcher(), self.module,
                                  seed=self.seed, device=self.device)
        ticks = int(config_get(root.common.net.job_ticks, 1) or 1)
        proto = loopback_proto(ticks)
        master.note_slave_protocol("local", proto)
        worker.note_net_proto(proto)
        for _ in range(max_cycles):
            if master.should_stop_serving():
                return
            job = master.generate_data_for_slave("local")
            if job is None:
                if master.should_stop_serving():
                    return
                raise Bug("population stalled: no member has work "
                          "yet the run is incomplete")
            replies = []
            worker.do_job(job, None, replies.append)
            master.apply_data_from_slave(replies[0], "local")
        raise Bug("population standalone run did not converge in "
                  "%d cycles" % max_cycles)

    # -- GA through the on-device vmap sub-population backend --------------

    def _vmap_backend_applicable(self):
        from ..genetics.core import collect_tunes
        from .vmap_backend import VmapSubPopulation
        try:
            return VmapSubPopulation.applicable(
                self.module, collect_tunes(root))
        except Bug:
            return False

    def _run_ga_vmap(self):
        from ..genetics.core import Population, collect_tunes
        from .vmap_backend import VmapSubPopulation
        tunes = collect_tunes(root)
        population = Population(
            tunes, self.size, self.generations, seed=self.seed,
            **{k: v for k, v in self.kwargs.items()
               if k in ("elite_ratio", "mutation_rate",
                        "blend_alpha", "stagnation")})
        backend = VmapSubPopulation(self.module, tunes, self.seed,
                                    device=self.device)
        self.info("GA over the vmap sub-population backend: one "
                  "device job per %d-member generation", self.size)
        best = backend.run_population(population, log=self.debug)
        self._ga_population = population
        if best is None:
            return None
        return ("ga", float(best.fitness),
                dict(best.overrides(tunes)))

    # -- reporting ---------------------------------------------------------

    def _finish(self, best):
        if best is None:
            self.warning("population run produced no evaluated "
                         "member")
            return
        member_id, fitness, hypers = best
        self.info("population run done (%s mode): best %s fitness "
                  "%.6f%s", self.mode, member_id, fitness,
                  " with %s" % hypers if hypers else "")
        summary = self.master.population_summary() \
            if self.master is not None else {"mode": self.mode}
        if self.result_file:
            dump_json({
                "mode": "population",
                "scheduling": self.mode,
                "size": self.size,
                "best_member": member_id,
                "best_fitness": fitness,
                "best_overrides": hypers,
                "summary": summary,
            }, self.result_file)
            self.info("population results -> %s", self.result_file)
