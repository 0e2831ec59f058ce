"""Container orchestration for third-party digital decoders.

Capability parity with the reference backend module (reference
``docker_backend.py``): engine connectivity probing, image inspection,
offline-first image acquisition (local image → bundled tar.xz → registry
pull), and a detached run that streams container logs to a callback and
maps the exit status.

Design differences from the reference: ``docker-py`` is imported lazily
(the DSP pipeline never needs it, tests inject a mock client, and
machines without Docker keep the rest of the package), every SDK call
goes through one error-translation helper, and image acquisition is a
strategy chain rather than nested conditionals.
"""

from __future__ import annotations

import contextlib
import logging
import lzma
import platform
import shutil
import sys
import tempfile
from collections.abc import Callable, Iterable, Sequence
from dataclasses import dataclass, field
from pathlib import Path

LOG = logging.getLogger(__name__)

DEFAULT_IMAGE = "ghcr.io/rknightion/iq-to-audio-backend:latest"
DEFAULT_AUDIO_TARGET = Path("/workspace/audio")

# Bundled image tars shipped per-arch by the desktop packaging job.
_BUNDLE_TAR_BY_ARCH = {
    "x86_64": "backend-amd64.tar.xz",
    "amd64": "backend-amd64.tar.xz",
    "arm64": "backend-arm64.tar.xz",
    "aarch64": "backend-arm64.tar.xz",
}


class DockerBackendError(RuntimeError):
    """Any failure while orchestrating the backend container."""


class DockerConnectionError(DockerBackendError):
    """The Docker engine is unreachable or docker-py is missing."""


class DockerLaunchError(DockerBackendError):
    """The container failed to start, stream, or exited non-zero."""


def _sdk_errors() -> tuple[type[BaseException], ...]:
    """The exception set worth catching around docker SDK calls."""
    try:
        from docker.errors import DockerException
    except ImportError:
        return (OSError,)
    return (DockerException, OSError)


def _raise_as(exc_type: type[DockerBackendError], exc: BaseException, fallback: str):
    """Translate an SDK exception into this module's hierarchy."""
    raise exc_type(str(exc).strip() or fallback) from exc


def default_decoder_command(command: Sequence[str] | None = None) -> tuple[str, ...]:
    """Normalize a decoder command to a tuple, defaulting to dsd-fme."""
    return tuple(command) if command else ("dsd-fme", "--help")


def _as_exit_code(value: object) -> int:
    """Container StatusCode as reported by the engine -> int, 1 if odd."""
    match value:
        case bool() | int() | float():
            return int(value)
        case str() if value.lstrip("-").isdigit():
            return int(value)
        case _:
            return 1


@dataclass(slots=True)
class DockerBackendConfig:
    """Shared settings for the backend container image."""

    image: str = DEFAULT_IMAGE
    audio_mount: Path = DEFAULT_AUDIO_TARGET
    environment: dict[str, str] = field(default_factory=dict)
    #: False: the runner removes the container itself after wait() (the
    #: _await_exit finally).  Daemon-side AutoRemove races attach()/wait()
    #: for fast-exiting commands (every digital preset defaults to
    #: '--help', exiting in milliseconds) — the daemon can reap the
    #: container first, turning a successful run into a NotFound error and
    #: losing the exit code.  Known docker-py pitfall.
    auto_remove: bool = False
    tty: bool = True
    stdin_open: bool = True


@dataclass(slots=True)
class DockerLaunchRequest:
    """One decoder invocation: the command plus the host audio directory
    that gets bind-mounted read-write at the configured mount point."""

    command: tuple[str, ...]
    audio_dir: Path
    decoder_key: str = "custom"
    pull_if_missing: bool = True

    def validate(self) -> None:
        problem = (
            "Launch request must include a command to execute inside the "
            "container."
            if not self.command
            else f"Audio directory does not exist: {self.audio_dir}"
            if not self.audio_dir.exists()
            else f"Audio path is not a directory: {self.audio_dir}"
            if not self.audio_dir.is_dir()
            else None
        )
        if problem:
            raise ValueError(problem)

    def mount_spec(self, target: Path) -> dict[str, dict[str, str]]:
        """docker-py volume mapping: host audio dir -> container target."""
        return {
            self.audio_dir.resolve().as_posix(): {
                "bind": target.as_posix(),
                "mode": "rw",
            }
        }


@dataclass(slots=True)
class DockerConnectivity:
    available: bool
    message: str


@dataclass(slots=True)
class DockerImageInfo:
    present: bool
    tags: list[str]
    created: str | None
    size_mb: float | None

    def format_status(self) -> str:
        if not self.present:
            return "Image not yet loaded"
        parts = [
            f"{self.size_mb:.0f} MB" if self.size_mb else "unknown size",
            f"built {self.created.split('T')[0]}" if self.created else "built ?",
        ]
        name = next(iter(self.tags), "unknown")
        return f"Image: {name} ({', '.join(parts)})"


class DockerBackend:
    """docker-py wrapper shared by the CLI ``digital`` subcommand and the
    GUI post-processing tab. Pass ``client=`` to inject a fake in tests."""

    def __init__(self, *, config: DockerBackendConfig | None = None, client=None) -> None:
        self.config = config or DockerBackendConfig()
        self._client = client if client is not None else self._connect()

    @staticmethod
    def _connect():
        try:
            import docker
        except ImportError as exc:
            raise DockerConnectionError(
                "The 'docker' Python package is not installed; digital decoder "
                "hand-off requires docker-py and a running Docker engine."
            ) from exc
        try:
            return docker.from_env()
        except Exception as exc:
            _raise_as(DockerConnectionError, exc, "Unable to create a Docker client.")

    @property
    def client(self):
        return self._client

    # ---- engine / image state ----

    def probe(self) -> DockerConnectivity:
        try:
            self._client.ping()
            # ping alone can succeed without list permissions
            self._client.containers.list(limit=1)
        except _sdk_errors() as exc:
            msg = str(exc).strip() or "Unable to communicate with the Docker engine."
            LOG.debug("Docker probe failed: %s", msg)
            return DockerConnectivity(False, msg)
        return DockerConnectivity(True, "Docker engine reachable.")

    def ensure_connection(self) -> None:
        state = self.probe()
        if not state.available:
            raise DockerConnectionError(state.message)

    def get_image_info(self) -> DockerImageInfo:
        try:
            img = self._client.images.get(self.config.image)
        except _sdk_errors():
            return DockerImageInfo(present=False, tags=[], created=None, size_mb=None)
        attrs = getattr(img, "attrs", {}) or {}
        nbytes = attrs.get("Size", 0)
        return DockerImageInfo(
            present=True,
            tags=list(getattr(img, "tags", []) or []),
            created=attrs.get("Created"),
            size_mb=nbytes / 2**20 if nbytes else None,
        )

    def pull_image(self) -> None:
        LOG.debug("Registry pull: %s", self.config.image)
        try:
            self._client.images.pull(self.config.image)
        except _sdk_errors() as exc:  # pragma: no cover - registry-specific
            _raise_as(DockerBackendError, exc, f"Failed to pull {self.config.image}.")

    # ---- offline-first bundled image ----

    @staticmethod
    def _locate_bundled_tar() -> Path | None:
        """The per-arch image tar shipped next to the frozen app (PyInstaller
        ``_MEIPASS``) or in the source tree's packaging directory."""
        frozen = getattr(sys, "frozen", False) and hasattr(sys, "_MEIPASS")
        root = (
            Path(sys._MEIPASS) / "docker"
            if frozen
            else Path(__file__).resolve().parents[2] / "packaging" / "docker"
        )
        name = _BUNDLE_TAR_BY_ARCH.get(platform.machine().lower())
        if name is None:
            LOG.warning(
                "No bundled backend image for this architecture (%s)",
                platform.machine(),
            )
            return None
        candidate = root / name
        return candidate if candidate.exists() else None

    def load_bundled_image(
        self, *, progress_callback: Callable[[str], None] | None = None
    ) -> bool:
        """Decompress + load the bundled tar.xz; False if none is shipped."""
        notify = progress_callback or (lambda _msg: None)
        src = self._locate_bundled_tar()
        if src is None:
            LOG.debug("No bundled backend image tar on disk")
            return False
        LOG.info("Found bundled backend image: %s", src)
        notify("Extracting bundled container image...")
        with tempfile.TemporaryDirectory(prefix="iq2a-docker-") as scratch:
            unpacked = Path(scratch) / "image.tar"
            try:
                with lzma.open(src, "rb") as packed, unpacked.open("wb") as raw:
                    shutil.copyfileobj(packed, raw)
            except (lzma.LZMAError, OSError) as exc:
                raise DockerBackendError(
                    f"Failed to decompress bundled image: {exc}"
                ) from exc
            notify("Loading container into Docker...")
            try:
                # stream the tar: backend images decompress to gigabytes,
                # and read_bytes() would materialise the whole tar in RAM
                with unpacked.open("rb") as tar_stream:
                    self._client.images.load(tar_stream)
            except _sdk_errors() as exc:
                raise DockerBackendError(
                    f"Failed to load bundled image into Docker: {exc}"
                ) from exc
        LOG.info("Bundled backend image loaded")
        return True

    def _ensure_image_available(self) -> None:
        """Acquisition chain: local image, then bundled tar, then registry;
        the first source that delivers wins, the registry failure is fatal."""

        def have_local() -> bool:
            with contextlib.suppress(*_sdk_errors()):
                self._client.images.get(self.config.image)
                return True
            return False

        def bundled() -> bool:
            LOG.info("Image not local; trying the bundled tar...")
            try:
                return self.load_bundled_image()
            except DockerBackendError:
                LOG.warning("Bundled image failed to load; will pull instead")
                return False

        def registry() -> bool:
            LOG.info("Pulling backend image from the registry...")
            self.pull_image()
            return True

        for acquire in (have_local, bundled, registry):
            if acquire():
                return

    # ---- run ----

    def run_and_stream(
        self,
        request: DockerLaunchRequest,
        *,
        log_callback: Callable[[str], None] | None = None,
        on_container: Callable[[str], None] | None = None,
    ) -> int:
        """Launch detached, stream logs, wait, and map the exit status.

        ``on_container`` receives the container id right after a successful
        start, before log streaming begins — callers use it to kill the
        container from another thread (the GUI's Stop Container button).

        Raises :class:`DockerLaunchError` on any non-zero exit.
        """
        request.validate()
        if request.pull_if_missing:
            self._ensure_image_available()
        emit = log_callback or (lambda line: LOG.info("%s", line.rstrip("\n")))
        LOG.debug(
            "Backend container: image=%s command=%s audio_dir=%s",
            self.config.image,
            request.command,
            request.audio_dir,
        )
        try:
            container = self._client.containers.run(
                image=self.config.image,
                command=list(request.command),
                detach=True,
                remove=self.config.auto_remove,
                volumes=request.mount_spec(self.config.audio_mount),
                working_dir=self.config.audio_mount.as_posix(),
                environment=self.config.environment or None,
                tty=self.config.tty,
                stdin_open=self.config.stdin_open,
            )
        except _sdk_errors() as exc:
            _raise_as(DockerLaunchError, exc, "Failed to start backend container.")

        if on_container is not None:
            on_container(container.id)
        try:
            for line in self._log_lines(container):
                emit(line)
        finally:
            outcome = self._await_exit(container)

        code = _as_exit_code(outcome.get("StatusCode", 1))
        if code != 0:
            err = outcome.get("Error")
            raise DockerLaunchError(
                str(err).strip()
                if err
                else f"Backend container exited with status {code}."
            )
        return code

    def kill_container(self, container_id: str) -> None:
        """Best-effort kill of a running backend container by id (the
        Stop Container path — safe to call from any thread)."""
        try:
            self._client.containers.get(container_id).kill()
        except _sdk_errors() as exc:
            LOG.debug("Container kill failed: %s", exc)

    def _log_lines(self, container) -> Iterable[str]:
        try:
            stream = container.attach(stream=True, stdout=True, stderr=True, logs=True)
        except _sdk_errors() as exc:
            _raise_as(DockerLaunchError, exc, "Unable to attach to backend container.")
        for raw in stream:
            yield raw.decode("utf-8", errors="replace") if isinstance(raw, bytes) else str(raw)

    def _await_exit(self, container) -> dict[str, object]:
        try:
            return dict(container.wait())
        except _sdk_errors() as exc:
            _raise_as(DockerLaunchError, exc, "Failed while waiting for container exit.")
        finally:
            if not self.config.auto_remove:
                with contextlib.suppress(Exception):
                    container.remove(force=True)
