"""Interactive annotation editors (tkinter), with headless-testable cores.

The port's ``findtextcenternet_tpu/tools/annotate_gui.py``: counterparts
of the reference's GUI finetune tools (upstream
``fine_image/fix_process_image1.py`` — per-box character and attribute
editor — and ``fix_line_image1.py`` — line/sep map painter). The
document/paint state lives in plain classes the GUIs are thin shells
over, so the logic is testable on a headless host; tkinter is imported
only by the shells. No model and no device are involved.

Usage:
    python -m findtextcenternet_tpu_torch.tools.annotate_gui boxes page.png
    python -m findtextcenternet_tpu_torch.tools.annotate_gui maps page.png
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

ATTR_KEYS = ("p_code1", "p_code2", "p_code4", "p_code8")
ATTR_LABELS = ("ruby", "rubybase", "emphasis", "space")


class BoxDocument:
    """Editable textbox annotation backing `fix_process_image1`-style
    editing: select boxes, set their character, toggle attribute flags,
    move/resize, add and delete."""

    def __init__(self, json_path: str):
        self.json_path = json_path
        with open(json_path, encoding="utf-8") as f:
            self.data = json.load(f)
        self.dirty = False

    @property
    def boxes(self) -> List[Dict]:
        return self.data.get("textbox", [])

    def hit_test(self, x: float, y: float) -> Optional[int]:
        """Topmost box whose rect contains (x, y); smallest wins ties."""
        best, best_area = None, None
        for i, b in enumerate(self.boxes):
            if abs(x - b["cx"]) <= b["w"] / 2 and \
                    abs(y - b["cy"]) <= b["h"] / 2:
                area = b["w"] * b["h"]
                if best is None or area < best_area:
                    best, best_area = i, area
        return best

    def set_text(self, index: int, text: str):
        self.boxes[index]["text"] = text[:1] if text else ""
        self.dirty = True

    def toggle_attr(self, index: int, key: str):
        b = self.boxes[index]
        b[key] = 0.0 if b.get(key, 0.0) > 0.5 else 1.0
        self.dirty = True

    def move(self, index: int, dx: float, dy: float):
        b = self.boxes[index]
        b["cx"] += dx
        b["cy"] += dy
        self.dirty = True

    def resize(self, index: int, dw: float, dh: float):
        b = self.boxes[index]
        b["w"] = max(2.0, b["w"] + dw)
        b["h"] = max(2.0, b["h"] + dh)
        self.dirty = True

    def add_box(self, cx: float, cy: float, w: float = 24.0,
                h: float = 24.0) -> int:
        self.boxes.append({
            "cx": float(cx), "cy": float(cy), "w": float(w), "h": float(h),
            "p_det": 1.0, "p_code1": 0.0, "p_code2": 0.0, "p_code4": 0.0,
            "p_code8": 0.0, "text": ""})
        self.dirty = True
        return len(self.boxes) - 1

    def delete(self, index: int):
        del self.boxes[index]
        self.dirty = True

    def save(self, path: Optional[str] = None):
        with open(path or self.json_path, "w", encoding="utf-8") as f:
            json.dump(self.data, f, ensure_ascii=False, indent=1)
        self.dirty = False


class MapDocument:
    """Editable line/sep probability maps backing `fix_line_image1`-style
    painting: brush strokes add or erase on either channel."""

    def __init__(self, image_path: str):
        from PIL import Image

        self.image_path = image_path
        img = Image.open(image_path)
        self.size = (img.height, img.width)
        h2, w2 = img.height // 2, img.width // 2
        self.lines = self._load(image_path + ".lines.png", (h2, w2))
        self.seps = self._load(image_path + ".seps.png", (h2, w2))
        self.dirty = False

    @staticmethod
    def _load(path: str, shape: Tuple[int, int]) -> np.ndarray:
        from PIL import Image

        if os.path.exists(path):
            arr = np.asarray(Image.open(path).convert("L"),
                             np.float32) / 255.0
            return arr
        return np.zeros(shape, np.float32)

    def paint(self, channel: str, x: float, y: float, radius: float,
              erase: bool = False):
        """Circular brush stroke at half-resolution map coords."""
        target = self.lines if channel == "lines" else self.seps
        h, w = target.shape
        x0 = max(0, int(x - radius))
        x1 = min(w, int(x + radius) + 1)
        y0 = max(0, int(y - radius))
        y1 = min(h, int(y + radius) + 1)
        if x1 <= x0 or y1 <= y0:
            return
        yy, xx = np.mgrid[y0:y1, x0:x1]
        mask = (xx - x) ** 2 + (yy - y) ** 2 <= radius ** 2
        target[y0:y1, x0:x1][mask] = 0.0 if erase else 1.0
        self.dirty = True

    def save(self):
        from PIL import Image

        Image.fromarray((self.lines * 255).astype(np.uint8)).save(
            self.image_path + ".lines.png")
        Image.fromarray((self.seps * 255).astype(np.uint8)).save(
            self.image_path + ".seps.png")
        self.dirty = False


# ---------------------------------------------------------------------------
# tkinter shells
# ---------------------------------------------------------------------------

def run_box_editor(image_path: str, json_path: Optional[str] = None):
    """Box/attribute editor: click selects, type sets the character,
    F1..F4 toggle ruby/rubybase/emphasis/space, arrows move, +/- resize,
    'a' adds at cursor, Delete removes, Ctrl-S saves."""
    import tkinter as tk

    from PIL import Image, ImageTk

    doc = BoxDocument(json_path or image_path + ".json")
    img = Image.open(image_path).convert("RGB")

    root = tk.Tk()
    root.title(f"box editor: {os.path.basename(image_path)}")
    canvas = tk.Canvas(root, width=min(img.width, 1400),
                       height=min(img.height, 900),
                       scrollregion=(0, 0, img.width, img.height))
    hbar = tk.Scrollbar(root, orient=tk.HORIZONTAL, command=canvas.xview)
    vbar = tk.Scrollbar(root, orient=tk.VERTICAL, command=canvas.yview)
    canvas.configure(xscrollcommand=hbar.set, yscrollcommand=vbar.set)
    canvas.grid(row=0, column=0, sticky="nsew")
    vbar.grid(row=0, column=1, sticky="ns")
    hbar.grid(row=1, column=0, sticky="ew")
    photo = ImageTk.PhotoImage(img)
    canvas.create_image(0, 0, anchor=tk.NW, image=photo)
    selected = [None]

    def redraw():
        canvas.delete("box")
        for i, b in enumerate(doc.boxes):
            color = "red" if i == selected[0] else (
                "blue" if b.get("text") else "green")
            canvas.create_rectangle(
                b["cx"] - b["w"] / 2, b["cy"] - b["h"] / 2,
                b["cx"] + b["w"] / 2, b["cy"] + b["h"] / 2,
                outline=color, tags="box")
            if b.get("text"):
                canvas.create_text(b["cx"], b["cy"] - b["h"] / 2 - 8,
                                   text=b["text"], fill="blue", tags="box")

    def on_click(ev):
        x = canvas.canvasx(ev.x)
        y = canvas.canvasy(ev.y)
        selected[0] = doc.hit_test(x, y)
        redraw()

    def on_key(ev):
        i = selected[0]
        if ev.keysym == "s" and ev.state & 0x4:       # Ctrl-S
            doc.save()
            root.title(f"saved {doc.json_path}")
            return
        if i is None:
            if ev.char == "a":
                x = canvas.canvasx(canvas.winfo_pointerx()
                                   - canvas.winfo_rootx())
                y = canvas.canvasy(canvas.winfo_pointery()
                                   - canvas.winfo_rooty())
                selected[0] = doc.add_box(x, y)
                redraw()
            return
        if ev.keysym == "Delete":
            doc.delete(i)
            selected[0] = None
        elif ev.keysym in ("F1", "F2", "F3", "F4"):
            doc.toggle_attr(i, ATTR_KEYS[int(ev.keysym[1]) - 1])
        elif ev.keysym == "Left":
            doc.move(i, -2, 0)
        elif ev.keysym == "Right":
            doc.move(i, 2, 0)
        elif ev.keysym == "Up":
            doc.move(i, 0, -2)
        elif ev.keysym == "Down":
            doc.move(i, 0, 2)
        elif ev.char == "+":
            doc.resize(i, 2, 2)
        elif ev.char == "-":
            doc.resize(i, -2, -2)
        elif ev.char and ev.char.strip():
            doc.set_text(i, ev.char)
        redraw()

    canvas.bind("<Button-1>", on_click)
    root.bind("<Key>", on_key)
    redraw()
    root.mainloop()


def run_map_painter(image_path: str):
    """Line/sep map painter: left-drag paints, right-drag erases, Tab
    switches lines/seps, [ ] change brush size, Ctrl-S saves."""
    import tkinter as tk

    from PIL import Image, ImageTk

    doc = MapDocument(image_path)
    base = Image.open(image_path).convert("RGB")
    h2, w2 = doc.lines.shape

    root = tk.Tk()
    state = {"channel": "lines", "radius": 4.0}
    root.title(f"map painter [{state['channel']}]: "
               f"{os.path.basename(image_path)}")
    canvas = tk.Canvas(root, width=min(base.width, 1400),
                       height=min(base.height, 900),
                       scrollregion=(0, 0, base.width, base.height))
    canvas.pack(fill=tk.BOTH, expand=True)
    photo = [None]

    def compose():
        overlay = np.asarray(base, np.float32).copy()
        lines_up = np.kron(doc.lines, np.ones((2, 2)))[:base.height,
                                                       :base.width]
        seps_up = np.kron(doc.seps, np.ones((2, 2)))[:base.height,
                                                     :base.width]
        overlay[..., 1] = np.minimum(
            255, overlay[..., 1] + lines_up * 120)
        overlay[..., 0] = np.minimum(255, overlay[..., 0] + seps_up * 120)
        photo[0] = ImageTk.PhotoImage(
            Image.fromarray(overlay.astype(np.uint8)))
        canvas.create_image(0, 0, anchor=tk.NW, image=photo[0])

    def stroke(ev, erase):
        x = canvas.canvasx(ev.x) / 2.0
        y = canvas.canvasy(ev.y) / 2.0
        doc.paint(state["channel"], x, y, state["radius"], erase=erase)
        compose()

    def on_key(ev):
        if ev.keysym == "Tab":
            state["channel"] = ("seps" if state["channel"] == "lines"
                                else "lines")
            root.title(f"map painter [{state['channel']}]")
        elif ev.char == "[":
            state["radius"] = max(1.0, state["radius"] - 1)
        elif ev.char == "]":
            state["radius"] += 1
        elif ev.keysym == "s" and ev.state & 0x4:
            doc.save()
            root.title("saved")

    canvas.bind("<B1-Motion>", lambda e: stroke(e, False))
    canvas.bind("<Button-1>", lambda e: stroke(e, False))
    canvas.bind("<B3-Motion>", lambda e: stroke(e, True))
    canvas.bind("<Button-3>", lambda e: stroke(e, True))
    root.bind("<Key>", on_key)
    compose()
    root.mainloop()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] not in ("boxes", "maps"):
        print(__doc__)
        return 1
    if argv[0] == "boxes":
        run_box_editor(argv[1], argv[2] if len(argv) > 2 else None)
    else:
        run_map_painter(argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
