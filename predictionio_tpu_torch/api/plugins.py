"""Engine-server plugins (a copy of ``predictionio_tpu/api/plugins.py``;
reference: EngineServerPlugin + PluginsActor in
core/.../workflow — SURVEY.md §5 'query server plugins hook for request
logging').

Two plugin kinds, as in the reference:
- ``output_blocker``: may transform/veto the prediction before it is sent.
- ``output_sniffer``: observes (query, prediction) pairs — request logging,
  metrics — without altering the response.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, List

log = logging.getLogger("pio.plugins")


class EngineServerPlugin(abc.ABC):
    name: str = "plugin"

    def start(self, state) -> None:  # called once at deploy
        pass


class OutputBlocker(EngineServerPlugin):
    @abc.abstractmethod
    def process(self, query: Any, prediction: Any) -> Any:
        """Return the (possibly transformed) prediction; raise to veto."""


class OutputSniffer(EngineServerPlugin):
    @abc.abstractmethod
    def process(self, query: Any, prediction: Any) -> None: ...


class PluginRegistry:
    def __init__(self):
        self.blockers: List[OutputBlocker] = []
        self.sniffers: List[OutputSniffer] = []

    def register(self, plugin: EngineServerPlugin) -> None:
        if isinstance(plugin, OutputBlocker):
            self.blockers.append(plugin)
        elif isinstance(plugin, OutputSniffer):
            self.sniffers.append(plugin)
        else:
            raise TypeError(f"{plugin!r} is neither OutputBlocker nor OutputSniffer")

    def all(self) -> List[EngineServerPlugin]:
        return [*self.blockers, *self.sniffers]

    def apply(self, query: Any, prediction: Any) -> Any:
        for b in self.blockers:
            prediction = b.process(query, prediction)
        for s in self.sniffers:
            try:
                s.process(query, prediction)
            except Exception:  # sniffers must never break serving
                log.exception("sniffer %s failed", s.name)
        return prediction


class RequestLogger(OutputSniffer):
    """Built-in request logger (reference ships a logging plugin sample)."""

    name = "request-logger"

    def __init__(self, logger: logging.Logger = None):
        self.logger = logger or logging.getLogger("pio.requests")

    def process(self, query, prediction) -> None:
        self.logger.info("query=%s prediction=%s", query, prediction)
