"""Tkinter GUI of the port; the JAX package's `gui/tk_app.py` running the
port's batch CLI: a form (paths, batch, threshold, min area, px/um,
overlays checkbox), an indeterminate progress bar, and the CLI run in a
worker thread (widget calls marshalled back through `root.after`).

    python -m unetdc_tpu_torch.gui.tk_app [--device {cuda,cpu}]

The child CLI runs on `--device` (default: the GPU); without a GPU the
default raises at start, as the CLI does."""

from __future__ import annotations

import subprocess
import threading

from unetdc_tpu_torch.gui.command import build_batch_command, gui_device


def main(argv=None):  # pragma: no cover - requires a display
    device = gui_device(argv)

    import tkinter as tk
    from tkinter import filedialog, messagebox, ttk

    root = tk.Tk()
    root.title(f"Droplet Quantifier ({device})")

    fields = {}

    def add_path_row(row, label, key, is_dir=True):
        tk.Label(root, text=label).grid(row=row, column=0, sticky="w")
        var = tk.StringVar()
        tk.Entry(root, textvariable=var, width=48).grid(row=row, column=1)
        fields[key] = var

        def browse():
            p = (filedialog.askdirectory() if is_dir
                 else filedialog.askopenfilename())
            if p:
                var.set(p)

        tk.Button(root, text="…", command=browse).grid(row=row, column=2)

    add_path_row(0, "Images folder", "img_dir")
    add_path_row(1, "Checkpoint (.pth/.msgpack)", "ckpt_path", is_dir=False)
    add_path_row(2, "Output folder", "out_dir")

    numeric = [("Batch size", "batch", "8"),
               ("Probability threshold", "prob_thresh", "0.3"),
               ("Min area (px²)", "min_area", "1"),
               ("Pixels per micron", "px_per_micron", "")]
    for i, (label, key, default) in enumerate(numeric, start=3):
        tk.Label(root, text=label).grid(row=i, column=0, sticky="w")
        var = tk.StringVar(value=default)
        tk.Entry(root, textvariable=var, width=12).grid(
            row=i, column=1, sticky="w")
        fields[key] = var

    overlays = tk.BooleanVar()
    tk.Checkbutton(root, text="Save overlays", variable=overlays).grid(
        row=7, column=1, sticky="w")

    bar = ttk.Progressbar(root, mode="indeterminate")
    bar.grid(row=8, column=0, columnspan=3, sticky="ew")

    def run_process():
        try:
            ppm = fields["px_per_micron"].get()
            cmd = build_batch_command(
                fields["img_dir"].get(), fields["ckpt_path"].get(),
                fields["out_dir"].get() or "quant_results",
                batch=int(fields["batch"].get()),
                prob_thresh=float(fields["prob_thresh"].get()),
                min_area=int(fields["min_area"].get()),
                px_per_micron=float(ppm) if ppm else None,
                save_overlays=overlays.get(), device=device)
        except ValueError as e:
            messagebox.showerror("Error", str(e))
            return

        def worker():
            # Tk is not thread-safe: all widget/dialog calls are marshaled
            # back to the main loop via root.after
            try:
                result = subprocess.run(cmd, capture_output=True, text=True)
                rc = result.returncode
                err = (result.stderr.splitlines()[-1]
                       if result.stderr else "process failed")
            except Exception as e:  # spawn failure etc.
                rc, err = -1, str(e)

            def finish():
                bar.stop()
                if rc == 0:
                    messagebox.showinfo("Done", "Quantification finished.")
                else:
                    messagebox.showerror("Error", err)

            root.after(0, finish)

        bar.start()
        threading.Thread(target=worker, daemon=True).start()

    tk.Button(root, text="Run", command=run_process).grid(row=9, column=1)
    root.mainloop()


if __name__ == "__main__":
    main()
