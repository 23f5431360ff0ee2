"""Vault integration: per-task token derivation, renewal, revocation.

Reference: nomad/vault.go (vaultClient: CreateToken, RenewToken,
RevokeTokens, accessor tracking + the server's own token renewal loop,
844 LoC) and the derive entrypoint Node.DeriveVaultToken
(nomad/node_endpoint.go:940). Two providers behind one surface:

- StubVault: in-process token store with TTLs, for unit speed and
  vault-less deployments;
- HTTPVaultProvider: the real thing — speaks Vault's token API
  (auth/token/create, renew, revoke-accessor, lookup-self) over HTTP
  with the server's own vault token, renewing that token at half-life
  like the reference's renewal loop (vault.go renewalLoop).

FakeVaultServer serves the same HTTP surface in-process so the wire
path is testable without a vault binary (the FakeConsulServer pattern,
consul/api.py).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..structs.alloc import VaultAccessor  # noqa: F401 — re-export
from ..utils.ids import generate_uuid


class VaultError(Exception):
    pass


class VaultProvider:
    """Provider surface the server needs (vault.go CreateToken:~,
    RenewToken, RevokeTokens)."""

    allowed_policies: Optional[List[str]] = None

    def _check_policies(self, policies: List[str]) -> None:
        """Nomad-side policy rules shared by every provider: root is
        always rejected (job_endpoint.go vault checks), and an operator
        allowlist restricts the rest."""
        if "root" in policies:
            raise VaultError("root policy cannot be derived for tasks")
        if self.allowed_policies is not None:
            bad = [p for p in policies if p not in self.allowed_policies]
            if bad:
                raise VaultError(f"policies not allowed: {bad}")

    def create_token(self, policies: List[str]) -> Tuple[str, str, float]:
        """Returns (token, accessor, ttl_seconds)."""
        raise NotImplementedError

    def renew_token(self, token: str) -> float:
        """Extends the token lease; returns the new ttl."""
        raise NotImplementedError

    def revoke_tokens(self, accessors: List[str]) -> None:
        raise NotImplementedError


@dataclass
class _StubToken:
    token: str
    accessor: str
    policies: List[str]
    expires: float


class StubVault(VaultProvider):
    """In-memory token authority with TTLs.

    Lookup-by-token works too so tests (and the dev agent) can assert a
    derived token is live, carries the requested policies, and dies on
    revocation/expiry.
    """

    def __init__(self, ttl: float = 3600.0, allowed_policies: Optional[List[str]] = None):
        self.ttl = ttl
        # None = allow any policy except root (the reference always
        # rejects root, job_endpoint.go vault checks).
        self.allowed_policies = allowed_policies
        self._lock = threading.Lock()
        self._by_token: Dict[str, _StubToken] = {}
        self._by_accessor: Dict[str, _StubToken] = {}
        self.logger = logging.getLogger("nomad_tpu_torch.vault.stub")

    def create_token(self, policies: List[str]) -> Tuple[str, str, float]:
        self._check_policies(policies)
        tok = _StubToken(
            token=f"s.{generate_uuid()}",
            accessor=generate_uuid(),
            policies=list(policies),
            expires=time.monotonic() + self.ttl,
        )
        with self._lock:
            self._by_token[tok.token] = tok
            self._by_accessor[tok.accessor] = tok
        return tok.token, tok.accessor, self.ttl

    def renew_token(self, token: str) -> float:
        with self._lock:
            tok = self._by_token.get(token)
            if tok is None:
                raise VaultError("unknown token")
            if tok.expires < time.monotonic():
                raise VaultError("token expired")
            tok.expires = time.monotonic() + self.ttl
        return self.ttl

    def revoke_tokens(self, accessors: List[str]) -> None:
        with self._lock:
            for acc in accessors:
                tok = self._by_accessor.pop(acc, None)
                if tok is not None:
                    self._by_token.pop(tok.token, None)

    # ------------------------------------------------------ test hooks

    def lookup(self, token: str) -> Optional[List[str]]:
        """Policies of a live token, None if revoked/expired/unknown."""
        with self._lock:
            tok = self._by_token.get(token)
            if tok is None or tok.expires < time.monotonic():
                return None
            return list(tok.policies)


class HTTPVaultProvider(VaultProvider):
    """Token authority over Vault's HTTP API (nomad/vault.go).

    `token` is the server's own vault token (config vault.token); every
    request carries it as X-Vault-Token. The reference validates it at
    startup and renews it at half-life forever (vault.go
    establishConnection + renewalLoop) — start_renewal()/stop() here.
    Policy allowlisting stays nomad-side (job_endpoint.go:84-120 checks
    at submit; the server consults `allowed_policies`), vault itself
    enforces whatever its own token policies allow.
    """

    def __init__(self, address: str, token: str, ttl: float = 3600.0,
                 allowed_policies: Optional[List[str]] = None,
                 timeout: float = 10.0):
        if "://" not in address:
            address = "http://" + address
        self.base = address.rstrip("/")
        self.token = token
        self.ttl = ttl
        self.allowed_policies = allowed_policies
        self.timeout = timeout
        self.logger = logging.getLogger("nomad_tpu_torch.vault.http")
        self._renew_stop: Optional[threading.Event] = None

    # ------------------------------------------------------------ wire

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        url = self.base + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"X-Vault-Token": self.token,
                     "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            try:
                errors = json.loads(detail).get("errors") or [detail]
            except ValueError:
                errors = [detail]
            raise VaultError(
                f"vault {method} {path}: {e.code} {'; '.join(errors)}") from e
        except (urllib.error.URLError, OSError) as e:
            raise VaultError(f"vault {method} {path}: {e}") from e
        if not payload:
            return {}
        try:
            return json.loads(payload)
        except ValueError as e:
            raise VaultError(f"vault {method} {path}: bad json") from e

    # ------------------------------------------------------- provider

    def create_token(self, policies: List[str]) -> Tuple[str, str, float]:
        self._check_policies(policies)
        resp = self._request("POST", "/v1/auth/token/create", {
            "policies": list(policies),
            "ttl": f"{int(self.ttl)}s",
            "display_name": "nomad-task",
            # Orphan-less child of the server token, like the reference
            # (vault.go CreateToken uses the role / non-orphan default):
            # revoking our token revokes every derived one.
            "renewable": True,
        })
        auth = resp.get("auth") or {}
        client_token = auth.get("client_token", "")
        accessor = auth.get("accessor", "")
        if not client_token or not accessor:
            raise VaultError("vault create returned no token")
        return client_token, accessor, float(
            auth.get("lease_duration") or self.ttl)

    def renew_token(self, token: str) -> float:
        resp = self._request("POST", "/v1/auth/token/renew", {
            "token": token, "increment": f"{int(self.ttl)}s",
        })
        auth = resp.get("auth") or {}
        return float(auth.get("lease_duration") or self.ttl)

    def revoke_tokens(self, accessors: List[str]) -> None:
        errors = []
        for acc in accessors:
            try:
                self._request("POST", "/v1/auth/token/revoke-accessor",
                              {"accessor": acc})
            except VaultError as e:
                # Unknown accessor = already revoked/expired: idempotent
                # like the reference's RevokeTokens; every OTHER failure
                # (including other 400s — malformed request, backend
                # errors) is collected so it is reported, and so one bad
                # accessor doesn't strand the rest.
                if "invalid accessor" in str(e).lower():
                    continue
                errors.append(str(e))
        if errors:
            raise VaultError("; ".join(errors))

    # ---------------------------------------------- own-token lifecycle

    def validate(self) -> dict:
        """Startup check of the server's own token (vault.go
        establishConnection lookup-self)."""
        resp = self._request("GET", "/v1/auth/token/lookup-self")
        return resp.get("data") or {}

    def start_renewal(self) -> None:
        """Renew our own token at half-life forever (vault.go
        renewalLoop); idempotent."""
        if self._renew_stop is not None:
            return
        stop = threading.Event()
        self._renew_stop = stop

        def loop():
            backoff = 5.0
            while not stop.is_set():
                try:
                    resp = self._request(
                        "POST", "/v1/auth/token/renew-self",
                        {"increment": f"{int(self.ttl)}s"})
                    lease = float(
                        (resp.get("auth") or {}).get("lease_duration")
                        or self.ttl)
                    wait = max(lease / 2.0, 1.0)
                    backoff = 5.0
                except VaultError as e:
                    self.logger.warning("self-renewal failed: %s", e)
                    wait = backoff
                    backoff = min(backoff * 2, 300.0)
                stop.wait(wait)

        threading.Thread(target=loop, name="vault-renew", daemon=True).start()

    def stop(self) -> None:
        if self._renew_stop is not None:
            self._renew_stop.set()
            self._renew_stop = None


class FakeVaultServer:
    """Vault's token HTTP API served off a StubVault-style store, for
    tests and dev clusters (the FakeConsulServer pattern). Knows one
    privileged root token; requests must present a live token."""

    def __init__(self, root_token: str = "", ttl: float = 3600.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.root_token = root_token or f"s.{generate_uuid()}"
        self.store = StubVault(ttl=ttl)
        self.tokens_created = 0
        self.renews = 0
        self.self_renews = 0
        self.revokes = 0
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                if not n:
                    return {}
                try:
                    return json.loads(self.rfile.read(n))
                except ValueError:
                    return {}

            def _reply(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _auth_ok(self):
                tok = self.headers.get("X-Vault-Token", "")
                if tok == fake.root_token or fake.store.lookup(tok) is not None:
                    return tok
                self._reply(403, {"errors": ["permission denied"]})
                return None

            def _handle(self):
                tok = self._auth_ok()
                if tok is None:
                    return
                path, body = self.path, self._body()
                try:
                    if path == "/v1/auth/token/create":
                        t, acc, ttl = fake.store.create_token(
                            body.get("policies") or [])
                        fake.tokens_created += 1
                        self._reply(200, {"auth": {
                            "client_token": t, "accessor": acc,
                            "lease_duration": int(ttl),
                            "policies": body.get("policies") or [],
                        }})
                    elif path == "/v1/auth/token/renew":
                        ttl = fake.store.renew_token(body.get("token", ""))
                        fake.renews += 1
                        self._reply(200, {"auth": {"lease_duration": int(ttl)}})
                    elif path == "/v1/auth/token/renew-self":
                        if tok != fake.root_token:
                            fake.store.renew_token(tok)
                        fake.self_renews += 1
                        inc = str(body.get("increment") or "").rstrip("s")
                        lease = (int(inc) if inc.isdigit()
                                 else int(fake.store.ttl))
                        self._reply(200, {"auth": {"lease_duration": lease}})
                    elif path == "/v1/auth/token/revoke-accessor":
                        if fake.store._by_accessor.get(
                                body.get("accessor", "")) is None:
                            self._reply(400, {"errors": ["invalid accessor"]})
                            return
                        fake.store.revoke_tokens([body.get("accessor", "")])
                        fake.revokes += 1
                        self._reply(204, {})
                    elif path == "/v1/auth/token/lookup-self":
                        pols = (["root"] if tok == fake.root_token
                                else fake.store.lookup(tok))
                        self._reply(200, {"data": {
                            "policies": pols, "renewable": True}})
                    else:
                        self._reply(404, {"errors": ["unsupported path"]})
                except VaultError as e:
                    self._reply(400, {"errors": [str(e)]})

            do_GET = do_POST = do_PUT = _handle

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.address = f"127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-vault", daemon=True)

    def start(self) -> "FakeVaultServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
