"""Independent security server (paper §2.3).

Maintains user accounts/passwords, per-user file-access ACLs, per-user client
IP allow-lists, and the slave IP allow-list that controls which machines may
join the system. The master consults it to verify clients and slaves; it
issues unique session ids on successful login.

The paper runs this as a separate process over SSL; here it is a separate
*object* with the same interface boundary (the master never reads the user
database directly).
"""

from __future__ import annotations

import dataclasses
import hashlib
import ipaddress
import itertools
from typing import Dict, List, Optional, Sequence, Tuple


class AccessDenied(Exception):
    """Raised when authentication or authorization fails."""


def _hash_password(password: str, salt: str) -> str:
    return hashlib.sha256((salt + ":" + password).encode()).hexdigest()


@dataclasses.dataclass
class UserRecord:
    name: str
    salt: str
    password_hash: str
    #: (path_prefix, mode) pairs; mode is a subset of "rw".
    acls: List[Tuple[str, str]]
    #: CIDR networks the user may connect from (empty = any).
    ip_networks: List[ipaddress.IPv4Network]


@dataclasses.dataclass
class Session:
    session_id: int
    user: str
    client_ip: str


class SecurityServer:
    """User database + slave allow-list + session issuance."""

    def __init__(self) -> None:
        self._users: Dict[str, UserRecord] = {}
        self._slave_networks: List[ipaddress.IPv4Network] = []
        self._session_counter = itertools.count(1)
        self._sessions: Dict[int, Session] = {}

    # -- administration -------------------------------------------------
    def add_user(
        self,
        name: str,
        password: str,
        acls: Sequence[Tuple[str, str]] = (("/", "rw"),),
        ip_ranges: Sequence[str] = (),
    ) -> None:
        salt = hashlib.sha256(name.encode()).hexdigest()[:8]
        self._users[name] = UserRecord(
            name=name,
            salt=salt,
            password_hash=_hash_password(password, salt),
            acls=list(acls),
            ip_networks=[ipaddress.ip_network(r) for r in ip_ranges],
        )

    def allow_slaves(self, *cidrs: str) -> None:
        """Add CIDR ranges to the slave allow-list (paper: 'only computers on
        this list can join as slaves')."""
        self._slave_networks.extend(ipaddress.ip_network(c) for c in cidrs)

    # -- slave verification ---------------------------------------------
    def verify_slave(self, ip: str) -> bool:
        if not self._slave_networks:
            return False  # closed by default: nothing may join
        addr = ipaddress.ip_address(ip)
        return any(addr in net for net in self._slave_networks)

    # -- client login ----------------------------------------------------
    def login(self, user: str, password: str, client_ip: str) -> Session:
        rec = self._users.get(user)
        if rec is None:
            raise AccessDenied(f"unknown user {user!r}")
        if _hash_password(password, rec.salt) != rec.password_hash:
            raise AccessDenied("bad password")
        if rec.ip_networks:
            addr = ipaddress.ip_address(client_ip)
            if not any(addr in net for net in rec.ip_networks):
                raise AccessDenied(f"client ip {client_ip} not allowed for {user}")
        session = Session(next(self._session_counter), user, client_ip)
        self._sessions[session.session_id] = session
        return session

    def logout(self, session_id: int) -> None:
        self._sessions.pop(session_id, None)

    def session(self, session_id: int) -> Optional[Session]:
        return self._sessions.get(session_id)

    # -- authorization ----------------------------------------------------
    def check_access(self, session_id: int, path: str, mode: str) -> None:
        """Raise AccessDenied unless the session's user may access ``path``
        with ``mode`` ('r' or 'w'). Longest matching ACL prefix wins."""
        session = self._sessions.get(session_id)
        if session is None:
            raise AccessDenied("invalid session")
        rec = self._users[session.user]
        best: Optional[Tuple[str, str]] = None
        for prefix, acl_mode in rec.acls:
            if path.startswith(prefix):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, acl_mode)
        if best is None or mode not in best[1]:
            raise AccessDenied(f"{session.user} lacks {mode!r} on {path!r}")
