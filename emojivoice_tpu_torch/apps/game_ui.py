"""Pygame rendering shell for the case3 story-building game (the port's
own copy of the JAX package's ``apps/game_ui.py``).

Rebuild of the reference's game window (reference:
case_studies/case3_game/main.py:271-401, configuration.py, sprites.py):
a fixed-size window with a background image, a black text bar across the
top, and typewriter-style rendering of the robot's reply (one char per
0.02 s frame).  pygame is absent from hermetic images, so the window is
gated: ``make_ui()`` returns a :class:`GameWindow` when pygame imports and
a :class:`ConsoleUI` with the same interface otherwise — the game loop in
apps/demos.py drives either without caring which.
"""

from __future__ import annotations

import os
import time
from typing import Optional

# reference: case3_game/configuration.py
WIN_WIDTH = 2000
WIN_HEIGHT = 1300
FPS = 60
GREEN = (35, 92, 6)
TEXT_BAR_HEIGHT = 100
TEXT_POS = (50, 50)
TYPEWRITER_DELAY_S = 0.02  # reference: main.py:333 time.sleep(0.02)
REPLY_SIZE = 35  # reference: main.py:327
NOTICE_SIZE = 55  # reference: main.py:383


def pygame_available() -> bool:
    try:
        import pygame  # noqa: F401

        return True
    except Exception:  # noqa: BLE001
        return False


class ConsoleUI:
    """Interface-compatible console fallback (what the reference's loop
    degenerates to without a display): typewriter → single print."""

    echoes_text = True  # typewriter prints; the game loop must not re-print

    def __init__(self):
        self.closed = False

    def pump(self) -> bool:
        """Process UI events; False means the user closed the window."""
        return not self.closed

    def typewriter(self, text: str) -> None:
        print(f"robot: {text}", flush=True)

    def notice(self, text: str) -> None:
        print(text, flush=True)

    def clear_text(self) -> None:
        pass

    def close(self) -> None:
        self.closed = True


class GameWindow:
    """The reference's pygame window: background + top text bar + typewriter.

    Only constructed when pygame imports (see :func:`make_ui`).
    """

    echoes_text = False  # display-only; the game loop logs to console

    def __init__(self, background: Optional[str] = None,
                 size=(WIN_WIDTH, WIN_HEIGHT), char_delay: float = TYPEWRITER_DELAY_S):
        import pygame

        self._pg = pygame
        pygame.init()
        self.screen = pygame.display.set_mode(size)
        pygame.display.set_caption("EmojiVoice story game")
        self.clock = pygame.time.Clock()
        self.char_delay = char_delay
        self.background = None
        if background:
            # reference sprites.py Background: image blitted at (0, 0)
            try:
                self.background = pygame.image.load(background)
            except Exception:  # noqa: BLE001 — missing asset ⇒ flat fill
                self.background = None
        self.closed = False
        self._draw_scene()

    # -- internals --------------------------------------------------------
    def _draw_scene(self) -> None:
        self.screen.fill(GREEN)
        if self.background is not None:
            self.screen.blit(self.background, (0, 0))
        self._pg.display.update()

    def _draw_bar(self) -> None:
        self._pg.draw.rect(self.screen, (0, 0, 0),
                           (0, 0, self.screen.get_width(), TEXT_BAR_HEIGHT))
        self._pg.display.update()

    def _draw_text(self, text: str, size: int) -> None:
        # reference main.py:264-269 draw_text
        font = self._pg.font.SysFont(None, size)
        surface = font.render(text, True, (255, 255, 255))
        rect = surface.get_rect()
        rect.topleft = TEXT_POS
        self.screen.blit(surface, rect)

    # -- interface shared with ConsoleUI ----------------------------------
    def pump(self) -> bool:
        if self.closed:
            return False
        for event in self._pg.event.get():
            if event.type == self._pg.QUIT:
                self.close()
                return False
        self.clock.tick(FPS)
        return True

    def typewriter(self, text: str) -> None:
        """Reveal the reply one character per frame (reference main.py:324-335)."""
        self._draw_bar()
        for n in range(1, len(text) + 1):
            self._draw_bar()
            self._draw_text(text[:n], REPLY_SIZE)
            self._pg.display.update()
            time.sleep(self.char_delay)

    def notice(self, text: str) -> None:
        """e.g. "I didn't hear anything, try recording again..."
        (reference main.py:378-389)."""
        self._draw_bar()
        self._draw_text(text, NOTICE_SIZE)
        self._pg.display.update()

    def clear_text(self) -> None:
        self._draw_bar()

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._pg.quit()


def make_ui(window: bool = True, background: Optional[str] = None,
            char_delay: float = TYPEWRITER_DELAY_S):
    """GameWindow when requested and pygame imports; ConsoleUI otherwise.

    Headless guard: with no DISPLAY and no SDL_VIDEODRIVER, SDL's x11 init
    can SEGFAULT the process (not raise) — fall back without touching it.
    Set SDL_VIDEODRIVER=dummy to force an off-screen window instead.
    """
    if window and pygame_available():
        if not os.environ.get("DISPLAY") and not os.environ.get("SDL_VIDEODRIVER"):
            return ConsoleUI()
        try:
            return GameWindow(background=background, char_delay=char_delay)
        except Exception:  # noqa: BLE001 — e.g. display server refused
            return ConsoleUI()
    return ConsoleUI()
