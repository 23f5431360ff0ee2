"""The HTTP API and its Python SDK (the port of the JAX package's api
package): ``HTTPServer`` serves the /v1/* routes, with blocking queries
parked on the server's read mux, and ``Client`` speaks them."""

from .client import Client
from .http import HTTPServer

__all__ = ["HTTPServer", "Client"]
