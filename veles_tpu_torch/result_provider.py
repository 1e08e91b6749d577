"""Results-contribution interface (the JAX package's
``result_provider``): units implementing it contribute to the
``--result-file`` metrics JSON gathered by
``Workflow.gather_results``."""


class IResultProvider(object):
    """Mixin marker: implement ``get_metric_names`` and
    ``get_metric_values``."""

    def get_metric_names(self):
        raise NotImplementedError()

    def get_metric_values(self):
        raise NotImplementedError()
