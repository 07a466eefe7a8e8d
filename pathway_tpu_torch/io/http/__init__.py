"""pw.io.http: the REST server connector and the HTTP client connectors.

The port's copy of the reference's ``io/http`` (upstream Pathway's
python/pathway/io/http/_server.py: PathwayWebserver :329, rest_connector
:624; __init__.py: read :100, write :158), served and fetched by the
standard library: ``read`` and ``write`` go through ``urllib.request``
where the reference goes through ``requests``."""

from ._client import read, write
from ._docs import EndpointDocumentation, EndpointExamples
from ._retry import DEFAULT_RETRY_CODES, RequestRunner, RetryPolicy
from ._server import PathwayWebserver, bound_serving_ports, rest_connector

__all__ = [
    "DEFAULT_RETRY_CODES",
    "EndpointDocumentation",
    "EndpointExamples",
    "PathwayWebserver",
    "RequestRunner",
    "RetryPolicy",
    "bound_serving_ports",
    "read",
    "rest_connector",
    "write",
]
