"""Population engine (the JAX package's ``population``), in-process
half: a GA population evaluated one vmapped generation at a time on the
device (:mod:`.vmap_backend`), driven by :class:`PopulationEngine`.

The fleet half — members as lineages scheduled across workers on the
delta data plane (``master``, ``worker``, ``lineage``), PBT, plain
member training and ``--ensemble-population`` — waits for ROADMAP A7a;
the engine raises, naming it, where a run needs it.
"""

from .engine import PopulationEngine  # noqa: F401
from .vmap_backend import VmapSubPopulation  # noqa: F401


def init_parser(parser):
    """The population flags of the command line that the port takes
    (``--pbt*`` and ``--ensemble-population`` wait for the fleet)."""
    parser.add_argument(
        "--population", default="", metavar="N[:GENERATIONS]",
        help="train N population members (GA mode when the config "
             "carries Tune() leaves of GD hyperparameters: one vmapped "
             "device job per generation; GENERATIONS caps the GA)")
    parser.add_argument(
        "--population-vmap", default=None, choices=("on", "off"),
        help="GA generations evaluate as ONE vmapped device job when "
             "every tune is a GD hyperparameter (default on; sets "
             "root.common.population.vmap; off, which forces fleet "
             "lineages, is not yet ported)")
