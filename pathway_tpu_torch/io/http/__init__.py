"""pw.io.http: the REST server connector.

The port's copy of the reference's ``io/http`` (upstream Pathway's
python/pathway/io/http/_server.py: PathwayWebserver :329,
rest_connector :624), served by the standard library. The HTTP client
connectors (``read``, ``write``) and their retrying request runner
come with ROADMAP Queue A item 1 and raise until then."""

from ._docs import EndpointDocumentation, EndpointExamples
from ._server import PathwayWebserver, bound_serving_ports, rest_connector

_CLIENT = "ROADMAP Queue A item 1 (the HTTP client connectors and their retry runner on urllib)"


def read(*args, **kwargs):
    """The reference's HTTP client reader; not ported yet."""
    raise NotImplementedError(f"pw.io.http.read needs {_CLIENT}")


def write(*args, **kwargs):
    """The reference's HTTP client writer; not ported yet."""
    raise NotImplementedError(f"pw.io.http.write needs {_CLIENT}")


__all__ = [
    "EndpointDocumentation",
    "EndpointExamples",
    "PathwayWebserver",
    "bound_serving_ports",
    "read",
    "rest_connector",
    "write",
]
