"""Qt stylesheets and palettes for the interactive UI (reference
``interactive/styles.py``: ``ColorPalette`` + app-wide QSS applied at
launch, reference ``app.py:2456``).

The stylesheet is *generated* from a palette rather than written long-hand,
so every widget rule stays consistent across the dark (default) and light
variants and adding a palette is one dataclass instance.  ``DARK_STYLESHEET``
remains the module contract the launcher applies.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ColorPalette:
    """Named colors one UI theme is built from."""

    window: str = "#1e222a"
    surface: str = "#262b35"
    surface_alt: str = "#2d333f"
    sunken: str = "#14171d"
    border: str = "#3a4150"
    border_light: str = "#4a5366"
    text: str = "#e8eaf0"
    text_dim: str = "#9aa3b5"
    accent: str = "#4f9dff"
    accent_dim: str = "#2d5f9e"
    accent_text: str = "#ffffff"
    warning: str = "#e0b04c"
    error: str = "#e06c75"
    success: str = "#7cc379"
    selection: str = "#2d5f9e"
    scrollbar: str = "#3a4150"
    scrollbar_hover: str = "#4f5b72"


PALETTE = ColorPalette()

LIGHT_PALETTE = ColorPalette(
    window="#f3f4f7",
    surface="#ffffff",
    surface_alt="#e9ecf2",
    sunken="#dfe3ea",
    border="#c6ccd8",
    border_light="#aeb6c6",
    text="#1c2230",
    text_dim="#5d6575",
    accent="#2563eb",
    accent_dim="#93b4f5",
    accent_text="#ffffff",
    warning="#9a6a00",
    error="#b4232f",
    success="#1d7a33",
    selection="#bcd3fb",
    scrollbar="#c6ccd8",
    scrollbar_hover="#aeb6c6",
)


def build_stylesheet(p: ColorPalette) -> str:
    """Full application QSS for one palette.

    Covers every widget class the UI instantiates (toolbar, panels, inputs,
    tables, consoles, dialogs, scrollbars, splitters) plus the dynamic
    ``dim``/``error``/``success`` label states the pages set via
    ``setProperty`` — the same surface the reference's 675-line QSS styles
    (reference ``styles.py:8-26``).
    """
    return f"""
/* ---- base ---------------------------------------------------------- */
QWidget {{
    background-color: {p.window};
    color: {p.text};
    font-size: 13px;
}}
QMainWindow::separator {{ background: {p.border}; width: 2px; }}
QToolTip {{
    background-color: {p.surface_alt};
    color: {p.text};
    border: 1px solid {p.border_light};
    padding: 4px 6px;
}}

/* ---- panels --------------------------------------------------------- */
QGroupBox {{
    background-color: {p.surface};
    border: 1px solid {p.border};
    border-radius: 6px;
    margin-top: 14px;
    padding: 8px 6px 6px 6px;
    font-weight: 600;
}}
QGroupBox::title {{
    subcontrol-origin: margin;
    left: 10px;
    padding: 0 4px;
    color: {p.text_dim};
}}
QScrollArea {{ border: none; }}
QSplitter::handle {{ background: {p.border}; }}
QSplitter::handle:hover {{ background: {p.accent_dim}; }}
QStackedWidget {{ background: transparent; }}

/* ---- buttons --------------------------------------------------------- */
QPushButton {{
    background-color: {p.surface_alt};
    border: 1px solid {p.border};
    border-radius: 4px;
    padding: 5px 14px;
}}
QPushButton:hover {{ border-color: {p.accent}; }}
QPushButton:pressed {{ background-color: {p.accent_dim}; color: {p.accent_text}; }}
QPushButton:disabled {{ color: {p.text_dim}; border-color: {p.border}; }}
QPushButton:focus {{ border-color: {p.accent}; outline: none; }}
QPushButton[accent="true"] {{
    background-color: {p.accent_dim};
    color: {p.accent_text};
    border-color: {p.accent};
}}
QPushButton[danger="true"] {{ border-color: {p.error}; color: {p.error}; }}

/* ---- inputs --------------------------------------------------------- */
QLineEdit, QComboBox, QSpinBox, QDoubleSpinBox {{
    background-color: {p.surface_alt};
    border: 1px solid {p.border};
    border-radius: 4px;
    padding: 3px 6px;
    selection-background-color: {p.selection};
}}
QLineEdit:focus, QComboBox:focus, QSpinBox:focus, QDoubleSpinBox:focus {{
    border-color: {p.accent};
}}
QLineEdit:disabled, QComboBox:disabled, QSpinBox:disabled,
QDoubleSpinBox:disabled {{ color: {p.text_dim}; background-color: {p.window}; }}
QLineEdit[invalid="true"] {{ border-color: {p.error}; }}
QComboBox::drop-down {{ border: none; width: 18px; }}
QComboBox QAbstractItemView {{
    background-color: {p.surface_alt};
    border: 1px solid {p.border_light};
    selection-background-color: {p.selection};
}}
QSpinBox::up-button, QSpinBox::down-button,
QDoubleSpinBox::up-button, QDoubleSpinBox::down-button {{
    background: {p.surface};
    border-left: 1px solid {p.border};
    width: 16px;
}}
QCheckBox {{ spacing: 6px; }}
QCheckBox::indicator {{
    width: 14px; height: 14px;
    border: 1px solid {p.border_light};
    border-radius: 3px;
    background: {p.surface_alt};
}}
QCheckBox::indicator:checked {{ background: {p.accent}; border-color: {p.accent}; }}
QCheckBox::indicator:disabled {{ background: {p.window}; border-color: {p.border}; }}

/* ---- progress / status ----------------------------------------------- */
QProgressBar {{
    background-color: {p.surface_alt};
    border: 1px solid {p.border};
    border-radius: 4px;
    text-align: center;
    height: 16px;
    color: {p.text};
}}
QProgressBar::chunk {{ background-color: {p.accent_dim}; border-radius: 3px; }}
QStatusBar {{ background: {p.surface}; border-top: 1px solid {p.border}; }}
QStatusBar QLabel {{ background: transparent; }}

/* ---- toolbar --------------------------------------------------------- */
QToolBar {{
    background: {p.surface};
    border-bottom: 1px solid {p.border};
    spacing: 6px;
    padding: 2px;
}}
QToolBar QToolButton {{
    background: transparent;
    border: 1px solid transparent;
    border-radius: 4px;
    padding: 4px 10px;
}}
QToolBar QToolButton:hover {{ border-color: {p.accent}; }}
QToolBar QToolButton:pressed {{ background: {p.accent_dim}; }}
QToolBar::separator {{ background: {p.border}; width: 1px; margin: 4px; }}

/* ---- tables ---------------------------------------------------------- */
QTableWidget, QTableView {{
    background-color: {p.surface};
    alternate-background-color: {p.surface_alt};
    gridline-color: {p.border};
    border: 1px solid {p.border};
    selection-background-color: {p.selection};
}}
QHeaderView::section {{
    background-color: {p.surface_alt};
    border: none;
    border-right: 1px solid {p.border};
    border-bottom: 1px solid {p.border};
    padding: 4px;
    font-weight: 600;
}}
QTableCornerButton::section {{ background: {p.surface_alt}; border: none; }}

/* ---- consoles / text ------------------------------------------------- */
QPlainTextEdit, QTextEdit {{
    background-color: {p.sunken};
    border: 1px solid {p.border};
    font-family: monospace;
    selection-background-color: {p.selection};
}}
QLabel[dim="true"] {{ color: {p.text_dim}; }}
QLabel[error="true"] {{ color: {p.error}; }}
QLabel[success="true"] {{ color: {p.success}; }}
QLabel[warning="true"] {{ color: {p.warning}; }}

/* ---- tabs ------------------------------------------------------------ */
QTabBar::tab {{
    background: {p.surface_alt};
    border: 1px solid {p.border};
    padding: 6px 16px;
    border-top-left-radius: 4px;
    border-top-right-radius: 4px;
}}
QTabBar::tab:selected {{ background: {p.surface}; border-bottom-color: {p.surface}; }}
QTabBar::tab:hover {{ border-color: {p.accent}; }}

/* ---- scrollbars ------------------------------------------------------ */
QScrollBar:vertical {{
    background: {p.window};
    width: 10px;
    margin: 0;
}}
QScrollBar::handle:vertical {{
    background: {p.scrollbar};
    border-radius: 5px;
    min-height: 24px;
}}
QScrollBar::handle:vertical:hover {{ background: {p.scrollbar_hover}; }}
QScrollBar:horizontal {{
    background: {p.window};
    height: 10px;
    margin: 0;
}}
QScrollBar::handle:horizontal {{
    background: {p.scrollbar};
    border-radius: 5px;
    min-width: 24px;
}}
QScrollBar::handle:horizontal:hover {{ background: {p.scrollbar_hover}; }}
QScrollBar::add-line, QScrollBar::sub-line {{ height: 0; width: 0; }}
QScrollBar::add-page, QScrollBar::sub-page {{ background: none; }}

/* ---- dialogs ---------------------------------------------------------- */
QDialog {{ background-color: {p.window}; }}
QMessageBox QLabel {{ background: transparent; }}
"""


DARK_STYLESHEET = build_stylesheet(PALETTE)
LIGHT_STYLESHEET = build_stylesheet(LIGHT_PALETTE)

STYLESHEETS = {"dark": DARK_STYLESHEET, "light": LIGHT_STYLESHEET}
