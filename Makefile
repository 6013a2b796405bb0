.PHONY: test check bench smoke native clean

test:
	python -m pytest tests/ -q

# Pre-commit gate: full suite + the entry points' syntax.
check:
	python -m pytest tests/ -q
	python -c "import ast; ast.parse(open('bench.py').read())"
	python -c "import ast; ast.parse(open('__graft_entry__.py').read())"

bench:
	python bench.py

smoke:
	python chip_smoke.py

native:
	g++ -O2 -shared -fPIC -pthread -std=c++17 fft_wgpu_tpu/native/src/fftcore.cpp \
	    -o fft_wgpu_tpu/native/libfftcore.so

clean:
	rm -f fft_wgpu_tpu/native/libfftcore.so
	find . -name __pycache__ -type d -exec rm -rf {} +
