.PHONY: test test-fast bench lint train-ljspeech train-emoji mas-lib clean \
	bench-torch mfu-torch bench-serving-torch bench-breakdown-torch lint-torch

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q -m fast -x

bench:
	python bench.py

lint:
	python tools/lint.py

mfu:
	python tools/mfu.py --out docs/artifacts/mfu.json

bench-serving:
	python tools/bench_serving.py

bench-breakdown:
	python tools/bench_breakdown.py

# the PyTorch port's twins (emojivoice_tpu_torch/bench/): on the card; --cpu runs them with no time measured
bench-torch:
	python -m emojivoice_tpu_torch.bench.synthesis

mfu-torch:
	python -m emojivoice_tpu_torch.bench.mfu

bench-serving-torch:
	python -m emojivoice_tpu_torch.bench.serving

bench-breakdown-torch:
	python -m emojivoice_tpu_torch.bench.breakdown

lint-torch:
	python tools/lint.py emojivoice_tpu_torch chip_smoke.py $(wildcard tests/test_torch_*.py)

mas-lib:
	python -c "from emojivoice_tpu.ops.mas_cpp import get_library; get_library(); print('libmas built')"

train-ljspeech:
	python -m emojivoice_tpu.training.train --preset ljspeech \
		--train_filelist data/LJSpeech-1.1/train.txt \
		--valid_filelist data/LJSpeech-1.1/val.txt --out_dir logs/ljspeech

train-emoji:
	python -m emojivoice_tpu.training.train --preset emoji_multi \
		--train_filelist data/emojis/train.txt \
		--valid_filelist data/emojis/validate.txt \
		--from_torch_ckpt models/base-vctk.ckpt --out_dir logs/emoji

clean:
	rm -rf emojivoice_tpu/ops/cpp/build .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
