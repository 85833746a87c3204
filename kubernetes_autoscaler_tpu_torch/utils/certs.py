"""Self-signed serving-certificate management.

Reference counterpart: vertical-pod-autoscaler/pkg/admission-controller's
cert self-management (certs/ — the webhook generates and rotates its own
serving certificate instead of requiring one to be provisioned). Used by the
VPA admission webhook server and available to the sidecar gRPC service.

`CertManager` keeps a cert/key pair under a directory, regenerating when
absent or within `rotate_before_s` of expiry; `reload()` hooks let a live
listener swap chains without rebinding (ssl.SSLContext.load_cert_chain may
be called again on a serving context — new handshakes pick up the new pair).
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import os
import threading


def generate_self_signed(
    common_name: str,
    sans: list[str] | None = None,
    valid_days: float = 365.0,
) -> tuple[bytes, bytes]:
    """(cert_pem, key_pem) for a self-signed serving certificate."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    alt_names: list[x509.GeneralName] = []
    for san in sans or [common_name, "localhost", "127.0.0.1"]:
        try:
            alt_names.append(x509.IPAddress(ipaddress.ip_address(san)))
        except ValueError:
            alt_names.append(x509.DNSName(san))
    now = _dt.datetime.now(_dt.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _dt.timedelta(minutes=5))
        .not_valid_after(now + _dt.timedelta(days=valid_days))
        .add_extension(x509.SubjectAlternativeName(alt_names), critical=False)
        .add_extension(
            x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .sign(key, hashes.SHA256())
    )
    return (
        cert.public_bytes(serialization.Encoding.PEM),
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )


class CertManager:
    """Keeps `<dir>/tls.crt` + `<dir>/tls.key` present and fresh."""

    def __init__(
        self,
        cert_dir: str,
        common_name: str = "localhost",
        sans: list[str] | None = None,
        valid_days: float = 365.0,
        rotate_before_s: float = 30 * 24 * 3600.0,
    ):
        self.cert_dir = cert_dir
        self.common_name = common_name
        self.sans = sans
        self.valid_days = valid_days
        self.rotate_before_s = rotate_before_s
        self.rotations = 0
        self._lock = threading.Lock()
        self._reload_hooks: list = []
        os.makedirs(cert_dir, exist_ok=True)
        self.ensure()

    @property
    def cert_path(self) -> str:
        return os.path.join(self.cert_dir, "tls.crt")

    @property
    def key_path(self) -> str:
        return os.path.join(self.cert_dir, "tls.key")

    def on_reload(self, hook) -> None:
        """hook(cert_path, key_path) runs after every (re)generation."""
        self._reload_hooks.append(hook)

    def _expires_at(self) -> float | None:
        from cryptography import x509

        try:
            with open(self.cert_path, "rb") as f:
                cert = x509.load_pem_x509_certificate(f.read())
        except (OSError, ValueError):
            return None
        try:
            return cert.not_valid_after_utc.timestamp()
        except AttributeError:  # cryptography < 42
            import datetime

            return cert.not_valid_after.replace(
                tzinfo=datetime.timezone.utc).timestamp()

    def ensure(self, now: float | None = None) -> bool:
        """Generate/rotate when absent or expiring soon; True if rotated."""
        import time

        now = time.time() if now is None else now
        with self._lock:
            exp = self._expires_at()
            if exp is not None and exp - now > self.rotate_before_s:
                return False
            cert_pem, key_pem = generate_self_signed(
                self.common_name, self.sans, self.valid_days)
            tmp_c, tmp_k = self.cert_path + ".tmp", self.key_path + ".tmp"
            with open(tmp_c, "wb") as f:
                f.write(cert_pem)
            # the private key must never be world-readable (0600, like the
            # k8s cert managers write theirs). Unlink first: os.open's mode
            # applies only on CREATION — a leftover tmp from a crashed run
            # would keep its old permissions
            try:
                os.unlink(tmp_k)
            except FileNotFoundError:
                pass
            fd = os.open(tmp_k, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(key_pem)
            os.replace(tmp_c, self.cert_path)
            os.replace(tmp_k, self.key_path)
            self.rotations += 1
            hooks = list(self._reload_hooks)
        # hooks run OUTSIDE the non-reentrant lock — a hook calling back
        # into ensure() must not deadlock (r4 advisor)
        for hook in hooks:
            hook(self.cert_path, self.key_path)
        return True
