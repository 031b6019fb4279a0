"""PySide6 GUI of the port; the JAX package's `gui/qt_app.py` running the
port's batch CLI.

The same window: a form (paths + batch / threshold / min-area /
px-per-micron / background-radius + overlays / excel / histogram toggles),
a `ProcessWorker(QThread)` that streams the CLI's stdout live into a log
pane and keeps the last 20 lines for an error tail, and a results viewer
that re-reads the produced CSVs/PNGs (summary + stats tables, histogram
preview, overlay gallery, open-output-folder button).

    python -m unetdc_tpu_torch.gui.qt_app [--device {cuda,cpu}]

The child CLI runs on `--device` (default: the GPU); without a GPU the
default raises at start, as the CLI does, rather than run on the CPU.
PySide6 is imported inside `main()`, so headless installs don't need Qt."""

from __future__ import annotations

import os
import subprocess
import sys

from unetdc_tpu_torch.gui.command import build_batch_command, gui_device


def main(argv=None):
    device = gui_device(argv)

    from PySide6.QtCore import QThread, Signal
    from PySide6.QtGui import QPixmap
    from PySide6.QtWidgets import (
        QApplication, QCheckBox, QDoubleSpinBox, QFileDialog, QFormLayout,
        QHBoxLayout, QLabel, QLineEdit, QMainWindow, QMessageBox,
        QPlainTextEdit, QPushButton, QScrollArea, QSpinBox, QTabWidget,
        QTableWidget, QTableWidgetItem, QVBoxLayout, QWidget)

    class ProcessWorker(QThread):
        line = Signal(str)
        finished_ok = Signal()
        finished_err = Signal(str)

        def __init__(self, cmd):
            super().__init__()
            self.cmd = cmd
            self._tail = []

        def run(self):
            proc = subprocess.Popen(
                self.cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, bufsize=1)
            for raw in proc.stdout:
                text = raw.rstrip("\n")
                self._tail = (self._tail + [text])[-20:]
                self.line.emit(text)
            proc.wait()
            if proc.returncode == 0:
                self.finished_ok.emit()
            else:
                self.finished_err.emit("\n".join(self._tail))

    class MainWindow(QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle(f"Droplet Quantifier ({device})")
            tabs = QTabWidget()
            self.setCentralWidget(tabs)

            # ---- run tab -------------------------------------------------
            run_w = QWidget()
            form = QFormLayout()
            self.img_dir = self._path_row(form, "Images folder", True)
            self.ckpt = self._path_row(form, "Checkpoint", False)
            self.out_dir = self._path_row(form, "Output folder", True)
            self.batch = QSpinBox(); self.batch.setRange(1, 256)
            self.batch.setValue(8)
            form.addRow("Batch size", self.batch)
            self.thresh = QDoubleSpinBox(); self.thresh.setDecimals(3)
            self.thresh.setRange(0, 1); self.thresh.setValue(0.3)
            form.addRow("Probability threshold", self.thresh)
            self.min_area = QSpinBox(); self.min_area.setRange(0, 10**6)
            self.min_area.setValue(1)
            form.addRow("Min area (px²)", self.min_area)
            self.ppm = QLineEdit()
            form.addRow("Pixels per micron (optional)", self.ppm)
            self.bg_radius = QSpinBox(); self.bg_radius.setRange(1, 500)
            self.bg_radius.setValue(50)
            form.addRow("Background radius", self.bg_radius)
            self.overlays = QCheckBox("Save overlays")
            self.excel = QCheckBox("Write Excel workbook")
            self.excel.setChecked(True)
            self.hist = QCheckBox("Write size histogram")
            self.hist.setChecked(True)
            form.addRow(self.overlays)
            form.addRow(self.excel)
            form.addRow(self.hist)
            self.run_btn = QPushButton("Run")
            self.run_btn.clicked.connect(self._on_run_clicked)
            form.addRow(self.run_btn)
            self.log = QPlainTextEdit(); self.log.setReadOnly(True)
            lay = QVBoxLayout(run_w)
            lay.addLayout(form)
            lay.addWidget(self.log)
            tabs.addTab(run_w, "Run")

            # ---- results tab ---------------------------------------------
            res_w = QWidget()
            rlay = QVBoxLayout(res_w)
            self.summary_table = QTableWidget()
            self.stats_table = QTableWidget()
            self.hist_label = QLabel("(histogram appears here)")
            self.gallery = QScrollArea(); self.gallery.setWidgetResizable(True)
            open_btn = QPushButton("Open output folder")
            open_btn.clicked.connect(self._open_out_dir)
            for wgt in (QLabel("summary_per_image.csv"), self.summary_table,
                        QLabel("droplet_size_stats.csv"), self.stats_table,
                        self.hist_label, self.gallery, open_btn):
                rlay.addWidget(wgt)
            tabs.addTab(res_w, "Results")

        def _path_row(self, form, label, is_dir):
            edit = QLineEdit()
            btn = QPushButton("…")

            def browse():
                p = (QFileDialog.getExistingDirectory(self) if is_dir
                     else QFileDialog.getOpenFileName(self)[0])
                if p:
                    edit.setText(p)

            btn.clicked.connect(browse)
            row = QWidget()
            h = QHBoxLayout(row)
            h.setContentsMargins(0, 0, 0, 0)
            h.addWidget(edit)
            h.addWidget(btn)
            form.addRow(label, row)
            return edit

        def _on_run_clicked(self):
            try:
                ppm = self.ppm.text().strip()
                cmd = build_batch_command(
                    self.img_dir.text(), self.ckpt.text(),
                    self.out_dir.text() or "quant_results",
                    batch=self.batch.value(),
                    prob_thresh=self.thresh.value(),
                    min_area=self.min_area.value(),
                    px_per_micron=float(ppm) if ppm else None,
                    save_overlays=self.overlays.isChecked(),
                    background_radius=self.bg_radius.value(),
                    skip_excel=not self.excel.isChecked(),
                    skip_histogram=not self.hist.isChecked(),
                    device=device)
            except ValueError as e:
                QMessageBox.critical(self, "Error", str(e))
                return
            self.run_btn.setEnabled(False)
            self.log.clear()
            self.worker = ProcessWorker(cmd)
            self.worker.line.connect(self.log.appendPlainText)
            self.worker.finished_ok.connect(self._on_run_succeeded)
            self.worker.finished_err.connect(self._on_run_failed)
            self.worker.start()

        def _on_run_succeeded(self):
            self.run_btn.setEnabled(True)
            self._update_visualizations()

        def _on_run_failed(self, tail):
            self.run_btn.setEnabled(True)
            QMessageBox.critical(self, "Run failed", tail)

        def _fill_table(self, table, csv_path):
            import pandas as pd

            if not os.path.exists(csv_path):
                return
            df = pd.read_csv(csv_path)
            table.setRowCount(len(df))
            table.setColumnCount(len(df.columns))
            table.setHorizontalHeaderLabels([str(c) for c in df.columns])
            for i in range(len(df)):
                for j, c in enumerate(df.columns):
                    table.setItem(i, j, QTableWidgetItem(str(df.iloc[i, j])))

        def _update_visualizations(self):
            out = self.out_dir.text() or "quant_results"
            self._fill_table(self.summary_table,
                             os.path.join(out, "summary_per_image.csv"))
            self._fill_table(self.stats_table,
                             os.path.join(out, "droplet_size_stats.csv"))
            hist = os.path.join(out, "size_histogram.png")
            if os.path.exists(hist):
                self.hist_label.setPixmap(QPixmap(hist).scaledToWidth(480))
            overlay_dir = os.path.join(out, "overlays")
            if os.path.isdir(overlay_dir):
                inner = QWidget()
                v = QVBoxLayout(inner)
                for f in sorted(os.listdir(overlay_dir))[:50]:
                    lab = QLabel()
                    lab.setPixmap(QPixmap(
                        os.path.join(overlay_dir, f)).scaledToWidth(480))
                    v.addWidget(QLabel(f))
                    v.addWidget(lab)
                self.gallery.setWidget(inner)

        def _open_out_dir(self):
            out = self.out_dir.text() or "quant_results"
            if sys.platform.startswith("linux"):
                subprocess.Popen(["xdg-open", out])
            elif sys.platform == "darwin":  # pragma: no cover
                subprocess.Popen(["open", out])
            else:  # pragma: no cover
                os.startfile(out)  # type: ignore[attr-defined]

    app = QApplication(sys.argv)
    win = MainWindow()
    win.resize(900, 700)
    win.show()
    sys.exit(app.exec())


if __name__ == "__main__":
    main()
