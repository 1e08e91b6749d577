"""Population engine (the JAX package's ``population``): GA, PBT and
ensemble members as fleet jobs on the delta data plane.

Members are long-lived weight lineages the master schedules across the
worker fleet: jobs are member-tagged multi-tick blocks, a worker's
update folds into that member's lineage only, a dropped worker's member
ticks requeue with their original step keys, PBT exploits ship as
deltas against synced state the workers already hold, and a GA
generation of GD hyperparameters runs as one vmapped device job.
"""

from .engine import PopulationEngine, loopback_proto  # noqa: F401
from .lineage import Lineage, build_member_workflow  # noqa: F401
from .master import (PopulationMaster,  # noqa: F401
                     live_population_summary, population_checksum)
from .vmap_backend import VmapSubPopulation  # noqa: F401
from .worker import PopulationWorker  # noqa: F401


def init_parser(parser):
    """The population flags of the command line."""
    parser.add_argument(
        "--population", default="", metavar="N[:GENERATIONS]",
        help="train N population members as fleet-scheduled lineages "
             "(GA mode when the config carries Tune() leaves — "
             "GENERATIONS caps the GA; PBT with --pbt; plain "
             "seed-varied member training otherwise)")
    parser.add_argument(
        "--pbt", action="store_true",
        help="population scheduling runs asynchronous Population "
             "Based Training: lagging members exploit a leader's "
             "weights (shipped as a delta) with perturbed hypers")
    parser.add_argument(
        "--pbt-interval", type=int, default=None, metavar="EPOCHS",
        help="validation epochs between a member's PBT fitness "
             "checks (default 1; sets "
             "root.common.population.pbt_interval)")
    parser.add_argument(
        "--pbt-quantile", type=float, default=None, metavar="Q",
        help="a member at or below this population fitness quantile "
             "exploits a leader (default 0.25; sets "
             "root.common.population.pbt_quantile)")
    parser.add_argument(
        "--pbt-perturb", type=float, default=None, metavar="F",
        help="explore step: exploited hypers multiply by F or 1/F "
             "(default 1.2; sets root.common.population.pbt_perturb)")
    parser.add_argument(
        "--population-vmap", default=None, choices=("on", "off"),
        help="GA generations evaluate as ONE vmapped device job when "
             "every tune is a GD hyperparameter (default on; sets "
             "root.common.population.vmap; off forces fleet lineages)")
    parser.add_argument(
        "--ensemble-population", action="store_true",
        help="route --ensemble-train instances through the "
             "population scheduler (fleet-trained ensemble members "
             "instead of sequential in-process runs)")
