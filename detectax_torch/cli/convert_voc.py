from detectax_torch.data.convert_voc import main  # noqa: F401

if __name__ == "__main__":
    main()
