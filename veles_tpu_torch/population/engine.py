"""Population run modes (the JAX package's ``population.engine``).

The port runs the GA mode over the on-device vmap sub-population
backend (:mod:`.vmap_backend`): when the config carries ``Tune`` leaves
that are all GD hyperparameters, each generation is one vmapped device
job, and the best member's genes go to the ``--result-file``.  The
other modes schedule members as lineages on the master/worker data
plane — plain member training, PBT, the self-driven loopback standalone
mode, the coordinator (``-l``) and the worker (``-m``) — and raise,
naming ROADMAP A7a, until the fleet is ported.
"""

from ..config import root
from ..error import Bug
from ..harness import seed_to_int
from ..json_encoders import dump_json
from ..logger import Logger

#: Why the modes other than GA-over-vmap are refused.
FLEET = ("needs population lineages on the master/worker data plane, "
         "which are not yet ported (ROADMAP A7a)")


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
            raise NotImplementedError("the population worker (-m) " +
                                      FLEET)
        if self.listen_address:
            raise NotImplementedError("the population coordinator (-l) "
                                      + FLEET)
        if self.mode != "ga":
            raise NotImplementedError("population %s mode %s" % (
                self.mode, FLEET))
        if not self._vmap_backend_applicable():
            raise NotImplementedError(
                "a GA population whose tunes are not all GD "
                "hyperparameters, or with root.common.population.vmap "
                "off, " + FLEET)
        best = self._run_ga_vmap()
        self._finish(best)
        return best

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
        if self.result_file:
            dump_json({
                "mode": "population",
                "scheduling": self.mode,
                "size": self.size,
                "best_member": member_id,
                "best_fitness": fitness,
                "best_overrides": hypers,
                "summary": {"mode": self.mode},
            }, self.result_file)
            self.info("population results -> %s", self.result_file)
