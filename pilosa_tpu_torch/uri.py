"""URI type (port of reference uri.go): scheme://host:port with
defaults scheme=http, host=localhost, port=10101."""

from __future__ import annotations

import re
from dataclasses import dataclass

DEFAULT_SCHEME = "http"
DEFAULT_HOST = "localhost"
DEFAULT_PORT = 10101

_URI_RE = re.compile(
    r"^(?:(?P<scheme>[a-zA-Z][a-zA-Z0-9+.-]*)://)?"
    r"(?P<host>\[[0-9a-fA-F:]+\]|[0-9a-zA-Z.\-_]*)?"
    r"(?::(?P<port>[0-9]+))?$"
)


class URIError(ValueError):
    pass


@dataclass
class URI:
    scheme: str = DEFAULT_SCHEME
    host: str = DEFAULT_HOST
    port: int = DEFAULT_PORT

    @classmethod
    def parse(cls, s: str) -> "URI":
        m = _URI_RE.match(s.strip())
        if m is None or not s.strip():
            raise URIError(f"invalid uri: {s!r}")
        scheme = m.group("scheme") or DEFAULT_SCHEME
        host = m.group("host") or DEFAULT_HOST
        port = int(m.group("port")) if m.group("port") else DEFAULT_PORT
        return cls(scheme=scheme, host=host, port=port)

    @property
    def host_port(self) -> str:
        return f"{self.host}:{self.port}"

    def normalize(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def __str__(self) -> str:
        return self.normalize()
